"""arrowtpu_torch.integration and arrowtpu_torch.cli against arrowtpu's.

Tolerance: exact.  Over tests/test_integration.py's type set (every
logical type the format carries: null, bool, the ints, floats, strings,
binary, fixed-size binary, decimals, dates, times, a zoned timestamp,
duration, intervals, list, fixed-size list, struct, map, dictionary,
run-end, dense union) the port's `to_json` document equals the JAX
package's, and each package's `from_json` of it gives the same columns
(dtypes, values by `to_pylist`; the flat and nested classes also by
`torch_parity.assert_column_equal`).  `python -m arrowtpu_torch.cli ...
--device cpu` prints what `python -m arrowtpu.cli ...` prints for
rowcount, schema and cat, and raises without a card when no device is
given; `convert` writes files equal in bytes to the JAX CLI's for each
target format; `json-integration` runs its three modes, its IPC file and
JSON document equal to the JAX CLI's.
"""

import decimal as D
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import torch_parity as tp
from torch_parity import release_jax_caches  # noqa: F401
from test_integration import _all_types_batch
import arrowtpu as at
from arrowtpu import cli as jcli
from arrowtpu import integration as jig
from arrowtpu import schema as js
from arrowtpu.core.column import from_pylist as jfrom_pylist
from arrowtpu.formats import parquet as jpq

from arrowtpu_torch import cli as pcli
from arrowtpu_torch import integration as pig
from arrowtpu_torch import schema as ps
from arrowtpu_torch.core.batch import RecordBatch, record_batch
from arrowtpu_torch.core.column import (dictionary_encode_host, from_pylist,
                                        run_end_from_pylist, union_column)
from arrowtpu_torch.ops.equal import equal_batches

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"


def _port_all_types_batch():
    """tests/test_integration.py's `_all_types_batch` in the port."""
    cols, fields = {}, []

    def add(name, c, dtype=None):
        fields.append(ps.Field(name, dtype if dtype is not None else c.dtype))
        cols[name] = c

    def fp(v, t=None):
        return from_pylist(v, t, CPU)

    add("nul", fp([None, None, None]))
    add("b", fp([True, None, False], ps.bool_))
    add("i8", fp([1, None, -3], ps.int8))
    add("u16", fp([1, 2, 65535], ps.uint16))
    add("i32", fp([1, None, -2**31], ps.int32))
    add("i64", fp([2**62, None, -5], ps.int64))
    add("u64", fp([2**63 + 1, 2, 3], ps.uint64))
    add("f32", fp([1.5, None, -2.25], ps.float32))
    add("f64", fp([1e300, None, -0.0], ps.float64))
    add("s", fp(["hello", None, "wörld-very-long-beyond-inline"], ps.utf8))
    add("bin", fp([b"\x00\xff", None, b"abc"], ps.binary))
    add("fsb", fp([b"0123", None, b"abcd"], ps.FixedSizeBinary(4)))
    add("d32", fp([D.Decimal("1.23"), None, D.Decimal("-9.99")],
                  ps.Decimal32(9, 2)))
    add("d128", fp([D.Decimal("12345678901234567890.12"), None,
                    D.Decimal("-1.00")], ps.Decimal128(38, 2)))
    add("d256", fp([D.Decimal(10)**70, None, D.Decimal(1)],
                   ps.Decimal256(76, 0)))
    add("date32", fp([19000, None, 0], ps.Date32()))
    add("date64", fp([1700000000000, None, 0], ps.Date64()))
    add("t32", fp([1000, None, 2000], ps.Time32("ms")))
    add("t64", fp([10**9, None, 5], ps.Time64("us")))
    add("ts", fp([1710054000123456, None, 0],
                 ps.Timestamp("us", "America/New_York")))
    add("dur", fp([5, None, -5], ps.Duration("ns")))
    add("iv_ym", fp([12, None, -1], ps.Interval("year_month")))
    add("iv_dt", fp([(1, 500), None, (-2, 0)], ps.Interval("day_time")))
    add("iv_mdn", fp([(1, 2, 3 * 10**10), None, (0, 0, -1)],
                     ps.Interval("month_day_nano")))
    add("lst", fp([[1, 2], None, []], ps.List(ps.int64)))
    add("fsl", fp([[1.0, 2.0], None, [3.0, 4.0]],
                  ps.FixedSizeList(ps.float64, 2)))
    add("strct", fp([{"x": 1, "y": "a"}, None, {"x": 2, "y": None}],
                    ps.Struct((ps.Field("x", ps.int32),
                               ps.Field("y", ps.utf8)))))
    add("mp", fp([[("k1", 1)], None, [("k2", 2), ("k3", 3)]],
                 ps.Map(ps.utf8, ps.int64)))
    add("dct", dictionary_encode_host(["aa", None, "bb"],
                                      ps.Dictionary(ps.int32, ps.utf8), CPU))
    add("ree", run_end_from_pylist([7, 7, 9], ps.int64, CPU))
    u_dt = ps.Union((ps.Field("i", ps.int32), ps.Field("s", ps.utf8)),
                    (0, 1), "dense")
    add("un", union_column([0, 1, 0], [fp([1, -1], ps.int32),
                                       fp(["x"], ps.utf8)],
                           u_dt, offsets=[0, 0, 1], length=3, device=CPU),
        u_dt)
    return RecordBatch(ps.Schema(tuple(fields)),
                       tuple(cols[f.name] for f in fields))


# the classes torch_parity.assert_column_equal compares layout for layout
_LAYOUT = {"nul", "b", "i8", "u16", "i32", "i64", "u64", "f32", "f64", "s",
           "bin", "fsb", "d32", "d128", "d256", "date32", "date64", "t32",
           "t64", "ts", "dur", "iv_ym", "iv_dt", "iv_mdn", "lst", "fsl",
           "strct", "mp"}


def _same_batches(jb, pb):
    assert [str(f.dtype) for f in pb.schema.fields] == \
        [str(f.dtype) for f in jb.schema.fields]
    for f in jb.schema.fields:
        assert pb[f.name].to_pylist() == jb[f.name].to_pylist(), f.name
        if f.name in _LAYOUT:
            tp.assert_column_equal(jb[f.name], pb[f.name], f.name)


def test_to_json_documents_equal_and_read_alike():
    jdoc = json.loads(json.dumps(jig.to_json([_all_types_batch()])))
    pdoc = json.loads(json.dumps(pig.to_json([_port_all_types_batch()])))
    assert pdoc == jdoc
    (jschema, (jb,)), (pschema, (pb,)) = jig.from_json(jdoc), \
        pig.from_json(jdoc, CPU)
    assert [(f.name, str(f.dtype), f.nullable) for f in pschema.fields] == \
        [(f.name, str(f.dtype), f.nullable) for f in jschema.fields]
    _same_batches(jb, pb)
    assert pb.device.type == "cpu"


def test_multi_batch_and_shape_conventions():
    def two(fp, s):
        return ({"x": fp([1, 2, None], s.int32)}, {"x": fp([4, 5], s.int32)})

    jbs = [at.record_batch(d) for d in two(jfrom_pylist, js)]
    pbs = [record_batch(d) for d in two(
        lambda v, t: from_pylist(v, t, CPU), ps)]
    assert pig.to_json(pbs) == jig.to_json(jbs)
    _, got = pig.from_json(pig.to_json(pbs), CPU)
    assert [b["x"].to_pylist() for b in got] == [[1, 2, None], [4, 5]]
    b = record_batch({"i64": from_pylist([2**60, None], ps.int64, CPU),
                      "s": from_pylist(["ab", "cdef"], ps.utf8, CPU),
                      "bin": from_pylist([b"\xde\xad", b""], ps.binary, CPU)})
    cols = {c["name"]: c for c in pig.to_json([b])["batches"][0]["columns"]}
    assert cols["i64"]["DATA"][0] == str(2**60)
    assert cols["i64"]["VALIDITY"] == [1, 0]
    assert cols["s"]["OFFSET"] == [0, 2, 6]
    assert cols["bin"]["DATA"][0] == "DEAD"
    d1 = record_batch({"d": dictionary_encode_host(["a"], device=CPU)})
    d2 = record_batch({"d": dictionary_encode_host(["b"], device=CPU)})
    with pytest.raises(ps.ArrowTpuError):
        pig.to_json([d1, d2])


def _source(tmp_path):
    """One Parquet file by the JAX writer, of ints, strings, floats, bools
    with nulls."""
    b = at.record_batch({
        "x": jfrom_pylist([1, 2, None, -7], js.int64),
        "s": jfrom_pylist(["a", None, "a string past twelve bytes", ""],
                          js.utf8),
        "f": jfrom_pylist([1.5, None, -0.25, 3.0], js.float64),
        "ok": jfrom_pylist([True, False, None, True], js.boolean)})
    src = tmp_path / "t.parquet"
    src.write_bytes(jpq.write_parquet(b))
    return str(src)


_RUN_CLI = r"""
import runpy, sys
for argv in sys.argv[2:]:
    sys.argv = ["cli"] + argv.split("\x1f")
    print("\x1e", flush=True)
    try:
        runpy.run_module(MODULE, run_name="__main__")
    except RuntimeError as e:
        print("RuntimeError:", e)
"""


def _python_m(module, argvs, env_extra=None):
    """`python -m module ARGV` for each ARGV in one process (runpy, as -m
    runs it) -> each one's stdout."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", JAX_PLATFORMS="cpu",
               **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    code = _RUN_CLI.replace("MODULE", repr(module))
    proc = subprocess.run(
        [sys.executable, "-c", code, "x"] + ["\x1f".join(a) for a in argvs],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.split("\x1e\n")[1:]


def test_cli_stdout_equal(tmp_path):
    src = _source(tmp_path)
    cmds = [["rowcount", src], ["schema", src], ["cat", src],
            ["cat", src, "--max-rows", "2", "--columns", "s,x"]]
    jout = _python_m("arrowtpu.cli", cmds)
    pout = _python_m("arrowtpu_torch.cli", [["--device", "cpu"] + c
                                            for c in cmds] + [cmds[0]])
    assert pout[:-1] == jout
    assert jout[0] == "4\n" and "x: int64" in jout[1]
    assert pout[-1].startswith("RuntimeError:") and "CUDA" in pout[-1]


def _both(argv, capsys):
    """The JAX CLI's and the port's (on the CPU) stdout of one command, in
    this process."""
    jcli.main(argv)
    jout = capsys.readouterr().out
    pcli.main(["--device", "cpu"] + argv)
    return jout, capsys.readouterr().out


@pytest.mark.parametrize("ext", ["csv", "json", "arrow", "arrows",
                                 "parquet"])
def test_convert_files_equal(tmp_path, capsys, ext):
    src = _source(tmp_path)
    jdst, pdst = (str(tmp_path / f"{w}.{ext}") for w in ("jax", "port"))
    jcli.main(["convert", src, jdst])
    pcli.main(["--device", "cpu", "convert", src, pdst])
    assert capsys.readouterr().out == f"wrote {jdst}\nwrote {pdst}\n"
    assert Path(pdst).read_bytes() == Path(jdst).read_bytes()
    jout, pout = _both(["cat", pdst], capsys)
    assert pout == jout


def test_json_integration_three_modes(tmp_path, capsys):
    jb = at.record_batch({"a": jfrom_pylist([1, None, 3], js.int64),
                          "s": jfrom_pylist(["x", "y", None], js.utf8)})
    jpath = str(tmp_path / "t.json")
    jig.write_json_file([jb], jpath)
    arrows = {}
    for who, main, pre in (("jax", jcli.main, []),
                           ("port", pcli.main, ["--device", "cpu"])):
        apath, back = (str(tmp_path / f"{who}{x}") for x in (".arrow",
                                                             ".json"))
        for mode, j in (("JSON_TO_ARROW", jpath), ("VALIDATE", jpath),
                        ("ARROW_TO_JSON", back)):
            main(pre + ["json-integration", "--mode", mode, "--json", j,
                        "--arrow", apath])
        arrows[who] = (Path(apath).read_bytes(), Path(back).read_text())
        out = capsys.readouterr().out
        assert out.splitlines()[1] == "validation OK"
    assert arrows["port"] == arrows["jax"]
    _, (pb,) = pig.read_json_file(str(tmp_path / "port.json"), CPU)
    _, (want,) = pig.read_json_file(jpath, CPU)
    assert bool(equal_batches(pb, want))
    bad = str(tmp_path / "bad.json")
    pig.write_json_file([record_batch({
        "a": from_pylist([1, 2, 4], ps.int64, CPU),
        "s": from_pylist(["x", "y", None], ps.utf8, CPU)})], bad)
    with pytest.raises(SystemExit, match="differs"):
        pcli.main(["--device", "cpu", "json-integration", "--mode",
                   "VALIDATE", "--json", bad, "--arrow",
                   str(tmp_path / "port.arrow")])
