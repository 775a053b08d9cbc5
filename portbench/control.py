"""The control of a cell at the cell's own size: for each seed, the tables
drawn as a run draws them, and for each item of the mix the reference's
answer in the precision the configuration states beside its answer in the
precision below it (DOUBLE decimals; UserID cut to 32 bits), compared as a
run compares the program's output.  Prints each number per seed and item;
the benchmark's runs never run it.

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...]
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import harness, mix  # noqa: E402


def readings(name: str, seed: int, device, scale: float = 1.0) -> list:
    cell = harness.Cell(name)
    arrays = {t: g.host_arrays(g.generate(cell.config, seed, device, scale))
              for t, g in cell.generators.items()}
    out = []
    for item, _ in mix.items(cell.mix, seed):
        q = cell.queries[item.query]
        tables = {t: harness.on_device(arrays[t], device) for t in q.TABLES}
        exact = q.reference(tables, item.kwargs, device)
        control = q.reference(tables, item.kwargs, device, control=True)
        out.append({"item": item.label(), **q.compare(control, exact)})
        del tables
    return out


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        for r in readings(args.workload, seed, device):
            print(json.dumps({"workload": args.workload, "seed": seed, **r}),
                  flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
