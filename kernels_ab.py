"""K1's 16-byte word and dense_agg timed in checkouts of the port, in turns,
on one card.

    python3 kernels_ab.py ROOT [ROOT ...] [--order 0,1,1,0]

Each ROOT is a checkout of this repository (the working tree, or a commit
unpacked by `git archive`).  For each entry of --order (indices into the
ROOTs; default each ROOT once) one process imports `arrowtpu_torch` from
that ROOT alone, builds its kernels there, draws the inputs from fixed
seeds on the card, holds every call to its plain version bit for bit and
times it (`probes.cold_ms`: the median of 30 calls, each after an L2
flush), then prints one JSON line; this process prints every line and a
table of min / max per shape and ROOT.  The shapes are those of the main
path's calls (chip_smoke.py phases 12, 13, 15 and 22), with masks and keys
drawn at the same kept shares and laws:

  K1 16 B   Q6's filter: 7 planes x 60,006,528 rows (SF10 lineitem's
            capacity), 1.899 % kept, output cut to the count rounded up to
            64 rows, tile offsets; the same planes at 50 % and 96 %; Q1's
            filter (6 planes, 98.588 %); a look-back call (2 planes x
            59,159,296 rows, 4 kept, 64 output rows: Q1's group keys'
            views)
  dense_agg config 4 (8,000,000 rows, int32 key in [0, 100), int64 value,
            128 buckets); ClickBench Q6 (599,985 uint8 AdvEngineIDs in
            [1, 30] by 1/rank, the key as its value, 128 buckets); every
            row in one bucket (8,000,000 rows, int64 value)

Beside each time: the bytes bound at 3.35 TB/s and, for K1, the sector
floor (the mask, a 32-byte sector read a kept word, 16 bytes written).
Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
Q6_ROWS = 60_006_528  # lineitem at SF10 in its batch's capacity
REPS = 30


def _bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def worker(root: str) -> dict:
    sys.path.insert(0, root)
    import torch
    from arrowtpu_torch.kernels import _build
    from arrowtpu_torch.kernels import compact3 as k1
    from arrowtpu_torch.kernels import dense_agg as dk
    from arrowtpu_torch.probes import cold_ms

    if not torch.cuda.is_available():
        raise SystemExit("kernels_ab: no CUDA device")
    dev = torch.device("cuda:0")
    _build.library()
    lines = {}

    def same(a, b) -> bool:
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))

    def timed(label, fn, plain, nbytes, sector_bytes=None, **extra):
        want = plain()
        if not same(fn(), want):
            raise AssertionError(f"{label}: differs from its plain version")
        del want
        line = {"ms": cold_ms(fn, REPS), "bound_ms": _bound_ms(nbytes),
                **extra}
        if sector_bytes is not None:
            line["sector_floor_ms"] = _bound_ms(sector_bytes)
        lines[label] = line

    g = torch.Generator(device=dev).manual_seed(20)
    planes = torch.randint(-2**31, 2**31 - 1, (7, Q6_ROWS, 4),
                           dtype=torch.int32, device=dev, generator=g)
    for label, P, share in (("K1 16 B, Q6 filter", 7, 0.01899),
                            ("K1 16 B, 50 %", 7, 0.5),
                            ("K1 16 B, 96 %", 7, 0.96),
                            ("K1 16 B, Q1 filter", 6, 0.98588)):
        keep = torch.rand(Q6_ROWS, device=dev, generator=g) < share
        offs = k1.tile_offsets(keep)
        kept = int(offs[-1])
        rows = -(-max(kept, 1) // 64) * 64
        sub = list(planes[:P])
        timed(label,
              lambda: k1.compact_planes(sub, keep, offs, rows),
              lambda: k1.compact_planes_plain(sub, keep, rows),
              Q6_ROWS + 16 * P * (kept + rows),
              Q6_ROWS + 32 * P * kept + 16 * P * rows,
              P=P, kept=kept, out_rows=rows)
        del keep, offs, sub
    del planes
    n = 59_159_296
    views = torch.randint(-2**31, 2**31 - 1, (2, n, 4), dtype=torch.int32,
                          device=dev, generator=g)
    keep = torch.zeros(n, dtype=torch.bool, device=dev)
    keep[torch.arange(4, device=dev) * (n // 4)] = True
    timed("K1 16 B, look-back call",
          lambda: k1.compact_planes(views, keep, None, 64),
          lambda: k1.compact_planes_plain(views, keep, 64),
          n + 16 * 2 * (4 + 64), n + 32 * 2 * 4 + 16 * 2 * 64,
          P=2, kept=4, out_rows=64)
    del views, keep

    def dense(label, key, kmin, nb, values):
        n = key.shape[0]
        args = (key, None, torch.tensor([kmin], dtype=torch.int64,
                                        device=dev), 0, nb, n, values)
        nbytes = (n * key.element_size()
                  + sum(n * v.element_size() for v, _ in values)
                  + (1 + 4 * len(values)) * nb * 8)
        timed(label, lambda: dk.dense_aggregate(*args),
              lambda: dk.dense_aggregate_plain(*args), nbytes, n=n, nb=nb)

    n = 8_000_000
    key = torch.randint(0, 100, (n,), dtype=torch.int32, device=dev,
                        generator=g)
    value = torch.randint(-1000, 1000, (n,), dtype=torch.int64, device=dev,
                          generator=g)
    dense("dense_agg, config 4 (100 keys)", key, 0, 128, [(value, None)])
    dense("dense_agg, one bucket", torch.full_like(key, 7), 0, 128,
          [(value, None)])
    adv_rows = 599_985
    share = 1.0 / torch.arange(1, 31, dtype=torch.float64, device=dev)
    adv = (1 + torch.multinomial(share / share.sum(), adv_rows,
                                 replacement=True, generator=g)
           ).to(torch.uint8)
    dense("dense_agg, ClickBench Q6", adv, 1, 128, [(adv, None)])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    return {"root": root, "card": card, "lines": lines}


def main(argv) -> int:
    if argv[:1] == ["--worker"]:
        print(json.dumps(worker(argv[1])), flush=True)
        return 0
    order = None
    if "--order" in argv:
        i = argv.index("--order")
        order = [int(x) for x in argv[i + 1].split(",")]
        argv = argv[:i] + argv[i + 2:]
    roots = argv
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    order = order if order is not None else list(range(len(roots)))
    runs = []
    for i in order:
        done = subprocess.run([sys.executable, __file__, "--worker",
                               roots[i]], capture_output=True, text=True)
        if done.returncode != 0:
            print(done.stdout + done.stderr, file=sys.stderr)
            return 1
        run = json.loads(done.stdout.strip().splitlines()[-1])
        print(json.dumps(run), flush=True)
        runs.append(run)
    print(runs[0]["card"])
    for label in runs[0]["lines"]:
        cells = []
        for root in roots:
            ms = [r["lines"][label]["ms"] for r in runs if r["root"] == root]
            if ms:
                cells.append(f"{root}: {min(ms):.4f}-{max(ms):.4f} ms")
        line = runs[0]["lines"][label]
        extra = (f", sector floor {line['sector_floor_ms']:.4f}"
                 if "sector_floor_ms" in line else "")
        print(f"{label}: {'; '.join(cells)} (bound {line['bound_ms']:.4f}"
              f"{extra})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
