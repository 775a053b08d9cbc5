"""Command-line tools over the engine.

Counterpart of `arrowtpu/cli.py` (arrow-rs's parquet/src/bin tools:
parquet-read, -schema, -rowcount, ...), with the same commands and output,
over the port's formats; every command takes `--device` (the card by
default; `--device cpu` runs on the host, and without a card nothing
runs unless it is given):

  python -m arrowtpu_torch.cli cat FILE [--max-rows N] [--columns a,b]
  python -m arrowtpu_torch.cli schema FILE
  python -m arrowtpu_torch.cli rowcount FILE
  python -m arrowtpu_torch.cli convert SRC DST       (format by extension)
  python -m arrowtpu_torch.cli bench [--rows N]      (a filter on the device)
  python -m arrowtpu_torch.cli json-integration --mode MODE --json J --arrow A

Formats are told by extension, then by magic: .parquet, .arrow / .ipc
(file), .arrows (stream), .csv, .json / .jsonl.
"""

from __future__ import annotations

import argparse
import json as _json
import time

import torch

from .config import resolve_device


def _detect(path: str) -> str:
    p = path.lower()
    if p.endswith(".parquet") or p.endswith(".pq"):
        return "parquet"
    if p.endswith(".arrow") or p.endswith(".ipc") or p.endswith(".feather"):
        return "ipc-file"
    if p.endswith(".arrows"):
        return "ipc-stream"
    if p.endswith(".csv"):
        return "csv"
    if p.endswith(".json") or p.endswith(".jsonl") or p.endswith(".ndjson"):
        return "json"
    with open(path, "rb") as f:
        head = f.read(8)
    if head[:4] == b"PAR1":
        return "parquet"
    if head[:6] == b"ARROW1":
        return "ipc-file"
    if head[:4] == b"\xff\xff\xff\xff":
        return "ipc-stream"
    return "csv"


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _read(path: str, device, columns=None):
    from .formats import csv as acsv, ipc as aipc, json as ajson
    from .formats import parquet as apq
    from .ops.concat import concat_batches

    kind = _detect(path)
    if kind == "parquet":
        return apq.read_parquet(_read_bytes(path), columns=columns,
                                device=device)
    if kind == "ipc-file":
        batches = aipc.read_file(_read_bytes(path), device=device)
    elif kind == "ipc-stream":
        batches = aipc.read_stream(_read_bytes(path), device=device)
    else:
        read = acsv.read_csv if kind == "csv" else ajson.read_json
        b = read(path, device=device)
        return b.project(columns) if columns else b
    out = batches[0] if len(batches) == 1 else concat_batches(batches)
    return out.project(columns) if columns else out


def cmd_cat(args, device):
    from .core import column as col
    from .ops.take import take_record_batch
    from .utils.pretty import pretty_format_batches

    cols = args.columns.split(",") if args.columns else None
    batch = _read(args.file, device, cols)
    # only the rows printed are read back to the host
    rows = min(max(args.max_rows, 0), batch.length)
    head = take_record_batch(batch, col.primitive(
        torch.arange(rows, device=device)))
    print(pretty_format_batches(head, max_rows=args.max_rows))


def _schema_and_rows(path: str, device):
    """(schema, row count): a Parquet file's from its footer, no column
    decoded; any other file's by reading it."""
    if _detect(path) == "parquet":
        from .formats.parquet import ParquetFile

        pf = ParquetFile(_read_bytes(path), device=device)
        return pf.schema, int(pf.num_rows)
    batch = _read(path, device)
    return batch.schema, int(batch.length)


def cmd_schema(args, device):
    for f in _schema_and_rows(args.file, device)[0].fields:
        null = "" if f.nullable else " NOT NULL"
        print(f"{f.name}: {f.dtype}{null}")


def cmd_rowcount(args, device):
    print(_schema_and_rows(args.file, device)[1])


def cmd_convert(args, device):
    from .formats import csv as acsv, ipc as aipc, json as ajson
    from .formats import parquet as apq

    batch = _read(args.src, device)
    kind = _detect(args.dst) if "." in args.dst else "parquet"
    with open(args.dst, "wb") as f:
        if kind == "parquet":
            f.write(apq.write_parquet(batch))
        elif kind == "ipc-file":
            f.write(aipc.write_file(batch))
        elif kind == "ipc-stream":
            f.write(aipc.write_stream(batch))
        elif kind == "csv":
            f.write(acsv.write_csv(batch).encode())
        else:
            f.write(ajson.write_json(batch).encode())
    print(f"wrote {args.dst}")


BENCH_REPS = 10


def cmd_bench(args, device):
    """filter_(x, gt(x, 0)) over datagen's int64 column (10 % nulls) on
    the device: one warm-up, then BENCH_REPS calls timed together (CUDA
    events on the card, the host clock on the CPU)."""
    from . import ops
    from .utils import datagen

    n = args.rows
    rng = datagen.seedable_rng(0)
    c = datagen.create_primitive_column(n, 0.1, rng=rng, device=device)

    def f():
        return ops.filter_(c, ops.gt(c, 0))

    f()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(BENCH_REPS):
            f()
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3 / BENCH_REPS
        name = torch.cuda.get_device_name(device)
    else:
        t0 = time.perf_counter()
        for _ in range(BENCH_REPS):
            f()
        dt = (time.perf_counter() - t0) / BENCH_REPS
        name = str(device)
    print(_json.dumps({"op": "filter(gt)", "rows": n, "seconds": dt,
                       "rows_per_s": n / dt, "device": name}))


def cmd_json_integration(args, device):
    """arrow-rs's arrow-json-integration-test binary: JSON_TO_ARROW,
    ARROW_TO_JSON and VALIDATE over the archery JSON format
    (integration.py) and the IPC file format; VALIDATE compares on the
    device (`ops.equal_batches`)."""
    from . import integration as ig
    from .formats import ipc
    from .ops.equal import equal_batches

    mode = args.mode.upper()
    if mode == "JSON_TO_ARROW":
        _, batches = ig.read_json_file(args.json, device)
        with open(args.arrow, "wb") as f:
            f.write(ipc.write_file(batches))
        print(f"wrote {args.arrow}")
    elif mode == "ARROW_TO_JSON":
        batches = ipc.read_file(_read_bytes(args.arrow), device=device)
        ig.write_json_file(batches, args.json)
        print(f"wrote {args.json}")
    elif mode == "VALIDATE":
        _, jb = ig.read_json_file(args.json, device)
        ab = ipc.read_file(_read_bytes(args.arrow), device=device)
        if len(jb) != len(ab):
            raise SystemExit(
                f"batch count mismatch: json={len(jb)} arrow={len(ab)}")
        for i, (x, y) in enumerate(zip(jb, ab)):
            if not bool(equal_batches(x, y)):
                raise SystemExit(f"batch {i} differs")
        print("validation OK")
    else:
        raise SystemExit(f"unknown mode {args.mode}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="arrowtpu_torch", description=__doc__)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in [("cat", cmd_cat), ("schema", cmd_schema),
                     ("rowcount", cmd_rowcount)]:
        sp = sub.add_parser(name)
        sp.add_argument("file")
        if name == "cat":
            sp.add_argument("--max-rows", type=int, default=40)
            sp.add_argument("--columns", default=None)
        sp.set_defaults(fn=fn)
    sp = sub.add_parser("convert")
    sp.add_argument("src")
    sp.add_argument("dst")
    sp.set_defaults(fn=cmd_convert)
    sp = sub.add_parser("bench")
    sp.add_argument("--rows", type=int, default=1 << 20)
    sp.set_defaults(fn=cmd_bench)
    sp = sub.add_parser("json-integration")
    sp.add_argument("--mode", required=True,
                    help="JSON_TO_ARROW | ARROW_TO_JSON | VALIDATE")
    sp.add_argument("--json", required=True)
    sp.add_argument("--arrow", required=True)
    sp.set_defaults(fn=cmd_json_integration)
    for sp in sub.choices.values():
        sp.add_argument("--device", default=argparse.SUPPRESS)
    args = p.parse_args(argv)
    # "cuda" is the card: resolve_device(None) raises when there is none
    args.fn(args, resolve_device(None if args.device == "cuda"
                                 else args.device))


if __name__ == "__main__":
    main()
