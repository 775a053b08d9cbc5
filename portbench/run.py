"""Run one cell of the benchmark of `arrowtpu_torch` on the card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints the result as one JSON line on
standard output, last, and each number compared beside its limit as the
last lines of standard error.  Exits non-zero, with no result, where there
is no CUDA device (or fewer than the cell asks for), where the port cannot
be imported, or where a module of JAX or of the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
# caches of compilers a run may start, at fixed paths inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(REPO / ".portbench_cache" / sub)
# one host thread for the CPU's math libraries: the port's host work is
# launches and Python, and idle worker threads only widen the spread of
# the host-paced cells (Q6: 1.8 % against 4.5 % over four runs on the
# card); set before torch is imported
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, str(REPO))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
