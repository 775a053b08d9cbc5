"""arrowtpu_torch stands alone: importing every one of its modules pulls in
neither JAX nor the JAX package, and with no CUDA device an entry point
that was not asked for the CPU raises instead of running there."""

import os
import subprocess
import sys
from pathlib import Path

from torch_parity import release_jax_caches  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, pkgutil, sys
import arrowtpu_torch
for m in pkgutil.walk_packages(arrowtpu_torch.__path__, "arrowtpu_torch."):
    importlib.import_module(m.name)
for name in ("kernels.compact2", "ops.join", "ops.take", "rowformat.hashing",
             "parallel.mesh", "parallel.shuffle", "parallel.distributed",
             "kernels.probes", "probes", "ops.sort", "kernels.dense_agg",
             "ops.groupby", "formats.parquet", "formats.parquet_ext",
             "formats.parquet_scan", "formats.parquet_push",
             "formats.parquet_record", "formats.parquet_nested",
             "formats.parquet_cdc", "formats.parquet_crypto", "formats.csv",
             "formats.json", "formats.avro", "formats.geospatial", "flight",
             "flightsql", "flightsql_meta", "extension", "tensor",
             "integration", "cli", "variant.encoding", "variant.array",
             "variant.shred", "variant.get", "variant.json"):
    assert "arrowtpu_torch." + name in sys.modules, name
import torch
assert not torch.cuda.is_available()
from arrowtpu_torch.entry import (agg_plan, agg_step, dryrun_multichip,
                                  entry, example_agg_batch, example_batch,
                                  example_lexsort_columns)
from arrowtpu_torch.parallel import run
from arrowtpu_torch.probes import run_probes
from arrowtpu_torch import cli, make_tensor, variant
for call in (entry, example_batch, lambda: dryrun_multichip(1),
             lambda: run(print, 1), example_lexsort_columns, run_probes,
             example_agg_batch, lambda: variant.variant_array([1]),
             lambda: make_tensor([1]), lambda: cli.main(["bench"])):
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


_OPTIONAL_PROBE = r"""
import importlib, pkgutil, sys
for name in ("zstandard", "cryptography", "pyarrow", "grpc"):
    sys.modules[name] = None  # an import of it raises ImportError
import arrowtpu_torch
for m in pkgutil.walk_packages(arrowtpu_torch.__path__, "arrowtpu_torch."):
    importlib.import_module(m.name)
from arrowtpu_torch.formats import parquet, parquet_scan
import numpy as np
b = arrowtpu_torch.record_batch({"x": arrowtpu_torch.column_from_numpy(
    np.arange(100), None, device="cpu")})
out, m = parquet_scan.scan_parquet(parquet.write_parquet(b), predicates=[
    parquet_scan.ColumnPredicate("x", "lt", 10)], device="cpu")
assert out["x"].to_pylist() == list(range(10))
from arrowtpu_torch import flight, flightsql
from arrowtpu_torch.formats import avro, csv, json
assert avro.read_avro(avro.write_avro(b), device="cpu").to_pydict() == \
    b.to_pydict()
assert csv.read_csv(csv.write_csv(b), device="cpu").to_pydict() == \
    json.read_json(json.write_json(b), device="cpu").to_pydict() == \
    b.to_pydict()
sql = flightsql.execute_select({"t": b}, "SELECT x FROM t WHERE x < 3")
assert sql.to_pydict() == {"x": [0, 1, 2]}
_, got = flight.decode_batches(flight.encode_batches(sql.schema, [sql]),
                               device="cpu")
assert got[0].to_pydict() == {"x": [0, 1, 2]}
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "arrowtpu") or sys.modules[m] is not None and
    m.split(".")[0] in ("zstandard", "cryptography", "pyarrow", "grpc"))
assert not bad, bad
print("ok")
"""


def test_parquet_needs_no_optional_package_at_import():
    """The Parquet modules import, and an uncompressed file writes and
    scans, with zstandard, cryptography, pyarrow and grpc missing: each is
    imported inside the calls that need it.  So do the row formats and
    Flight's framing and FlightSQL's statements, which run with no
    socket."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", _OPTIONAL_PROBE], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
