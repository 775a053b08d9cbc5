"""arrowtpu_torch.core.validate against arrowtpu.core.validate and Python's
UTF-8 decoder, and the IPC path of TPC-H lineitem with `validate=True`.

Tolerance: exact.  `_utf8_invalid` gives every row's verdict as the JAX
package's (one `jax.jit` at one (65536, 4) shape for every matrix) and as
`bytes.decode("utf-8")` over every 2-byte sequence, every (lead, second
byte) pair padded with 0x80 and with 0xBF to 3 and 4 bytes, and the JAX
test's lists (tests/test_validate.py).  `validate_column` sets the JAX
package's flags, by name, on the malformed columns tests/test_validate.py
builds (each built in both packages) and on their struct and list-view
parents; `check_batch` raises the JAX package's message.  The path: a
20,000-row lineitem draw written by the port as an IPC file and stream,
read back with `validate=True` to the same rows, Q6 exact against its
oracle, and the two corruptions (a 0xFF byte in an l_comment, an
l_shipmode key of 7) raising ValidationError with their flags.
"""

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ipc_spans
import torch_parity as tp
from torch_parity import release_jax_caches  # noqa: F401
import arrowtpu as at
from arrowtpu import schema as js
from arrowtpu.core import column as jcol
from arrowtpu.core import validate as jval

from arrowtpu_torch import entry as pe
from arrowtpu_torch import schema as ps
from arrowtpu_torch.core import batch as pbt
from arrowtpu_torch.core import column as pcol
from arrowtpu_torch.core import validate as pval
from arrowtpu_torch.formats import ipc as pipc

ROWS, WIDTH = 65536, 4
_jax_utf8 = tp.jit(jval._utf8_invalid)


def _matrices():
    """(name, (ROWS, WIDTH) uint8 matrix, lengths) of the exhaustive
    cases."""
    a, b = np.divmod(np.arange(ROWS), 256)
    out = []
    two = np.zeros((ROWS, WIDTH), np.uint8)
    two[:, 0], two[:, 1] = a, b
    out.append(("every 2-byte sequence", two, np.full(ROWS, 2, np.int32)))
    for pad in (0x80, 0xBF):
        for width in (3, 4):
            m = two.copy()
            m[:, 2:width] = pad
            out.append((f"(lead, byte) + {pad:#x} to {width} bytes", m,
                        np.full(ROWS, width, np.int32)))
    return out


def _lists():
    """The JAX test's valid and invalid strings, in one (64, 16) matrix."""
    good = ["hello".encode(), b"", "héllo".encode(), "日本語".encode(),
            "\U0001F389 emoji".encode(), b"\x7f", "ࠀ￿".encode(),
            "\U0010FFFF".encode()]
    bad = [b"\x80", b"\xc3", b"\xc0\xaf", b"\xe0\x80\xaf", b"\xed\xa0\x80",
           b"\xf0\x80\x80\x80", b"\xf5\x80\x80\x80", b"\xf4\x90\x80\x80",
           b"\xc3\x28", b"\xff"]
    strings = good + bad
    m = np.zeros((64, 16), np.uint8)
    lens = np.zeros(64, np.int32)
    for i, s in enumerate(strings):
        m[i, :len(s)] = np.frombuffer(s, np.uint8)
        lens[i] = len(s)
    return strings, m, lens


def _python_invalid(m, lens):
    out = np.zeros(len(lens), bool)
    for i, (row, n) in enumerate(zip(m, lens)):
        try:
            bytes(row[:n]).decode("utf-8")
        except UnicodeDecodeError:
            out[i] = True
    return out


@pytest.mark.parametrize("case", range(5))
def test_utf8_matches_jax_and_python(case):
    name, m, lens = _matrices()[case]
    got = pval._utf8_invalid(torch.from_numpy(m), torch.from_numpy(lens))
    want = np.asarray(_jax_utf8(jnp.asarray(m), jnp.asarray(lens)))
    np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    np.testing.assert_array_equal(got.numpy(), _python_invalid(m, lens),
                                  err_msg=name)


def test_utf8_lists_of_the_jax_test():
    strings, m, lens = _lists()
    got = pval._utf8_invalid(torch.from_numpy(m), torch.from_numpy(lens))
    want = np.asarray(_jax_utf8(jnp.asarray(m), jnp.asarray(lens)))
    np.testing.assert_array_equal(got.numpy(), want)
    n = len(strings)
    assert got[:n].tolist() == [not _decodes(s) for s in strings]
    assert got[:8].sum() == 0 and got[8:n].all()


def _decodes(s):
    try:
        s.decode("utf-8")
        return True
    except UnicodeDecodeError:
        return False


def test_chunked_check_equals_one_matrix(monkeypatch):
    """The row chunks of `utf8_invalid_rows` give the rows of one whole
    matrix (chunks of 64 rows here, over 1,000 strings)."""
    rng = np.random.default_rng(3)
    words = [bytes(rng.integers(0, 256, int(k), dtype=np.uint8))
             if rng.random() < 0.3 else "é" * int(k)
             for k in rng.integers(0, 30, 1000)]
    c = pcol.string_view(words, ps.binary, device="cpu")
    ok = c.valid_bool()
    whole = pval.utf8_invalid_rows(c, ok)
    monkeypatch.setattr(pval, "UTF8_CHUNK_BYTES", 1)
    assert torch.equal(pval.utf8_invalid_rows(c, ok), whole)
    assert whole[:1000].tolist() == [
        not _decodes(w if isinstance(w, bytes) else w.encode())
        for w in words]


# ---------------------------------------------------------------------------
# validate_column: the malformed columns of tests/test_validate.py
# ---------------------------------------------------------------------------


def _columns(colmod, st, device):
    """{name: column} in one package: good columns and the malformed ones
    of tests/test_validate.py, and their struct and list-view parents."""
    kw = {} if device is None else {"device": device}
    d = colmod.dictionary_encode_host(["x", "y", "x", None], **kw)
    s = colmod.string_view(["a-string-longer-than-twelve-bytes", "ok"], **kw)
    bad_utf8 = colmod.string_view(
        [b"ok", b"\xff\xfe-definitely-not-utf8", b"x", b"fine"],
        dtype=st.utf8, **kw)
    lv = colmod.list_view([[1, 2], [3]], **kw)
    if device is None:
        bad_keys = dataclasses.replace(
            d, keys=dataclasses.replace(
                d.keys, values=jnp.full_like(d.keys.values, 99)))
        bad_views = dataclasses.replace(
            s, views=s.views.at[0, 3].set(jnp.uint32(10**8)))
        bad_starts = dataclasses.replace(
            lv, starts=jnp.full_like(lv.starts, 10**6))
    else:
        bad_keys = dataclasses.replace(
            d, keys=dataclasses.replace(
                d.keys, values=torch.full_like(d.keys.values, 99)))
        views = s.views.clone()
        views[0, 3] = 10**8
        bad_views = dataclasses.replace(s, views=views)
        bad_starts = dataclasses.replace(
            lv, starts=torch.full_like(lv.starts, 10**6))
    return {
        "ints": colmod.from_pylist([1, None, 3], st.int64, **kw),
        "strings": colmod.string_view(
            ["a", None, "long-string-over-twelve-b"], **kw),
        "dictionary": d, "bad_keys": bad_keys, "bad_views": bad_views,
        "bad_utf8": bad_utf8,
        "binary": colmod.string_view([b"\xff\xfe"], dtype=st.binary, **kw),
        "bad_starts": bad_starts,
        "struct": colmod.struct_column(
            [{"a": 1, "s": "x"}, None, {"a": 3, "s": "zz"}], **kw),
        "list_of_strings": colmod.list_view([["a", "é"], None, []], **kw)}


@pytest.fixture(scope="module")
def both():
    return _columns(jcol, js, None), _columns(pcol, ps, "cpu")


def _set(flags):
    return {k for k, v in flags.items() if bool(np.asarray(v))}


FLAGGED = {"bad_keys": {"dict_key_out_of_bounds"},
           "bad_views": {"view_out_of_bounds"},
           "bad_utf8": {"invalid_utf8"},
           "bad_starts": {"list_view_out_of_bounds"}}


@pytest.mark.parametrize("name", list(_columns(pcol, ps, "cpu")))
def test_flags_match_jax(name, both):
    jc, pc = both[0][name], both[1][name]
    jflags = jval.validate_column(jc)
    pflags = pval.validate_column(pc)
    assert list(pflags) == list(jflags)
    assert _set(pflags) == _set(jflags) == FLAGGED.get(name, set())
    assert list(pval.validate_column(pc, full=False)) == list(
        jval.validate_column(jc, full=False))


def test_children_flags_match_jax(both):
    """A struct of (ints, the bad utf8 column) and a list view whose child
    is the bad utf8 column: the flags carry their prefixes."""
    got = []
    for cols, st, colmod, val in ((both[0], js, jcol, jval),
                                  (both[1], ps, pcol, pval)):
        bad = cols["bad_utf8"]
        ints = colmod.from_pylist([1, 2, 3, 4], st.int64, **(
            {} if val is jval else {"device": "cpu"}))
        stype = st.Struct((st.Field("i", st.int64), st.Field("s", st.utf8)))
        parent = colmod.StructColumn((ints, bad), None, 4, stype)
        lparent = dataclasses.replace(cols["list_of_strings"], child=bad)
        got.append((_set(val.validate_column(parent)),
                    _set(val.validate_column(lparent))))
    assert got[0] == got[1] == ({"child1.invalid_utf8"},
                                {"child.invalid_utf8"})


def test_check_batch_message_matches_jax(both):
    jcols, pcols = both
    names = ["bad_keys", "dictionary", "bad_utf8"]
    msgs = []
    for val, rb, cols in ((jval, at.record_batch, jcols),
                          (pval, pbt.record_batch, pcols)):
        with pytest.raises((js.ValidationError, ps.ValidationError)) as e:
            val.check_batch(rb({n: cols[n] for n in names}))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == (
        "invalid array data in batch: bad_keys.dict_key_out_of_bounds, "
        "bad_utf8.invalid_utf8")
    with pytest.raises(ps.ValidationError, match="in s: invalid_utf8"):
        pval.check_column(pcols["bad_utf8"], name="s")
    pval.check_column(pcols["strings"], name="ok")


# ---------------------------------------------------------------------------
# the path: lineitem through IPC, validated, then Q6
# ---------------------------------------------------------------------------

SF = 20_000 / 6_000_000


@pytest.fixture(scope="module")
def lineitem():
    arrays = pe.example_lineitem_arrays(SF)
    return arrays, pe.lineitem_batch(arrays, device="cpu")


@pytest.mark.parametrize("stream", [False, True])
def test_lineitem_round_trip_and_q6(lineitem, stream):
    arrays, batch = lineitem
    data = pe.lineitem_ipc(batch, 4096, stream=stream)
    got = pe.read_lineitem_ipc(data, validate=True, device="cpu")
    assert pe.check_same_rows(got, batch, same_dictionary=False) == \
        batch.length == len(arrays["l_orderkey"])
    with pytest.raises(AssertionError, match="dictionary was not kept"):
        pe.check_same_rows(got, batch)
    want = pe.q6_oracle(arrays)
    assert pe.check_q6(pe.q6_step(got), arrays, want) > 0
    if not stream:
        r = pipc.FileReader(data, device="cpu")
        from arrowtpu_torch.ops.coalesce import slice_batch

        for k in (1, r.num_batches - 1):
            assert pe.check_same_rows(
                r.get_batch(k), slice_batch(batch, 4096 * k, 4096),
                same_dictionary=False) > 0


def test_lineitem_corruptions_raise(lineitem):
    _, batch = lineitem
    sink = io.BytesIO()
    pe.lineitem_ipc(batch, 4096, stream=True, sink=sink)
    buf = sink.getbuffer()
    spans = ipc_spans.batch_buffers(buf)
    off, _ = spans[1]["l_comment"][2]  # the second batch's bytes
    saved = buf[off + 5]
    buf[off + 5] = 0xFF
    with pytest.raises(ps.ValidationError,
                       match=r"^invalid array data in batch: "
                             r"l_comment\.invalid_utf8$"):
        pe.read_lineitem_ipc(buf, validate=True, device="cpu")
    assert pe.read_lineitem_ipc(buf, validate=False,
                                device="cpu").length == batch.length
    buf[off + 5] = saved
    off, _ = spans[0]["l_shipmode"][1]
    saved = bytes(buf[off:off + 4])
    buf[off:off + 4] = np.int32(len(pe.SHIPMODE)).tobytes()
    with pytest.raises(ps.ValidationError,
                       match=r"l_shipmode\.dict_key_out_of_bounds$"):
        pe.read_lineitem_ipc(buf, device="cpu")
    buf[off:off + 4] = saved
    pe.read_lineitem_ipc(buf, device="cpu")


@pytest.mark.parametrize("offset", [1 << 30, -(1 << 30)])
def test_lineitem_bad_offset_raises(lineitem, offset):
    """An l_comment offset past the data or below zero: the offsets
    decrease there, which the read with validate=True flags on the host
    before the views are built (ROADMAP C.3, fault 17); building the
    column without validate reads no byte outside the data, and the full
    check of that column flags the views it gives (a string running past
    the arena, a negative length)."""
    _, batch = lineitem
    sink = io.BytesIO()
    pe.lineitem_ipc(batch, 4096, stream=True, sink=sink)
    buf = sink.getbuffer()
    off, _ = ipc_spans.batch_buffers(buf)[1]["l_comment"][1]
    buf[off + 4 * 100:off + 4 * 101] = np.int32(offset).tobytes()
    with pytest.raises(ps.ValidationError,
                       match=r"^invalid array data in batch: "
                             r"l_comment\.offsets_decreasing$"):
        pe.read_lineitem_ipc(buf, validate=True, device="cpu")
    got = pipc.read_stream(buf, device="cpu")
    assert [b.length for b in got] == [
        min(4096, batch.length - i) for i in range(0, batch.length, 4096)]
    # the full check over the views that read gives, UTF-8 included
    with pytest.raises(ps.ValidationError,
                       match=r"^invalid array data in batch: "
                             r"l_comment\.view_out_of_bounds, "
                             r"l_comment\.negative_length$"):
        pval.check_batch(got[1])


def test_negative_view_length_is_fault_16_of_the_jax_package(both):
    """A view length with its top bit set: Arrow's int32 length is
    negative, and the port flags `negative_length`; the JAX package reads
    it as uint32 and flags `view_out_of_bounds` instead (ROADMAP C.3,
    fault 16).  full=False: the JAX package's UTF-8 check would build a
    byte matrix of that width."""
    jc, pc = both[0]["strings"], both[1]["strings"]
    jbad = dataclasses.replace(jc, views=jc.views.at[2, 0].set(
        jnp.uint32(0xFFFFFFF0)))
    views = pc.views.clone()
    views[2, 0] = -16
    pbad = dataclasses.replace(pc, views=views)
    assert _set(jval.validate_column(jbad, full=False)) == {
        "view_out_of_bounds"}
    assert _set(pval.validate_column(pbad, full=False)) == {
        "negative_length"}
