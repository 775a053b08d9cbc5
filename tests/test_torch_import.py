"""arrowtpu_torch stands alone: importing every one of its modules pulls in
neither JAX nor the JAX package, and with no CUDA device an entry point
that was not asked for the CPU raises instead of running there."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, pkgutil, sys
import arrowtpu_torch
for m in pkgutil.walk_packages(arrowtpu_torch.__path__, "arrowtpu_torch."):
    importlib.import_module(m.name)
for name in ("kernels.compact2", "ops.join", "ops.take", "rowformat.hashing",
             "parallel.mesh", "parallel.shuffle", "parallel.distributed",
             "kernels.probes", "probes", "ops.sort", "kernels.dense_agg",
             "ops.groupby"):
    assert "arrowtpu_torch." + name in sys.modules, name
import torch
assert not torch.cuda.is_available()
from arrowtpu_torch.entry import (agg_plan, agg_step, dryrun_multichip,
                                  entry, example_agg_batch, example_batch,
                                  example_lexsort_columns)
from arrowtpu_torch.parallel import run
from arrowtpu_torch.probes import run_probes
for call in (entry, example_batch, lambda: dryrun_multichip(1),
             lambda: run(print, 1), example_lexsort_columns, run_probes,
             example_agg_batch):
    try:
        call()
    except RuntimeError as e:
        assert "CUDA" in str(e), e
    else:
        raise AssertionError(f"{call} ran without a CUDA device")
step, (batch,) = entry(device="cpu")
assert step(batch).length > 0
assert dryrun_multichip(1, device="cpu") > 0
small = example_agg_batch(device="cpu")
assert agg_step(agg_plan(small), small).length == 100
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "arrowtpu"))
assert not bad, bad
print("ok")
"""


def test_port_imports_no_jax_and_needs_cuda_by_default():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
