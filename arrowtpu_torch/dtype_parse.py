"""DataType text parser: parse `str(dtype)` back to a DataType.

The port's own copy of `arrowtpu/dtype_parse.py` over the port's schema
(it imports nothing of the JAX package): the grammar is the types' display
format (schema.py `__str__`, the same strings in both packages), and
parse_datatype(str(dt)) == dt for every type the port has."""

from __future__ import annotations

from . import schema as st

_SIMPLE = {
    "null": st.null,
    "bool": st.bool_,
    "boolean": st.bool_,
    "utf8": st.utf8,
    "binary": st.binary,
    "int8": st.int8,
    "int16": st.int16,
    "int32": st.int32,
    "int64": st.int64,
    "uint8": st.uint8,
    "uint16": st.uint16,
    "uint32": st.uint32,
    "uint64": st.uint64,
    "float16": st.float16,
    "float32": st.float32,
    "float64": st.float64,
    "date32": st.Date32(),
    "date64": st.Date64(),
}


class _P:
    def __init__(self, s: str):
        self.s = s
        self.i = 0

    def peek(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else ""

    def eat(self, tok: str):
        self.skip_ws()
        if not self.s.startswith(tok, self.i):
            raise st.SchemaError(
                f"datatype parse error at {self.i} in {self.s!r}: expected {tok!r}"
            )
        self.i += len(tok)

    def skip_ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def ident(self) -> str:
        self.skip_ws()
        j = self.i
        while j < len(self.s) and (self.s[j].isalnum() or self.s[j] in "_."):
            j += 1
        out = self.s[self.i : j]
        self.i = j
        return out

    def int(self) -> int:
        self.skip_ws()
        j = self.i
        if self.peek() == "-":
            j += 1
        while j < len(self.s) and self.s[j].isdigit():
            j += 1
        out = int(self.s[self.i : j])
        self.i = j
        return out

    def dtype(self) -> st.DataType:
        name = self.ident()
        if name in _SIMPLE:
            return _SIMPLE[name]
        if name in ("decimal32", "decimal64", "decimal128", "decimal256"):
            self.eat("(")
            p = self.int()
            self.eat(",")
            s = self.int()
            self.eat(")")
            cls = {"decimal32": st.Decimal32, "decimal64": st.Decimal64,
                   "decimal128": st.Decimal128,
                   "decimal256": st.Decimal256}[name]
            return cls(p, s)
        if name == "fixed_size_binary":
            self.eat("[")
            w = self.int()
            self.eat("]")
            return st.FixedSizeBinary(w)
        if name == "interval":
            self.eat("[")
            unit = self.ident()
            self.eat("]")
            return st.Interval(unit)
        if name in ("timestamp", "time32", "time64", "duration"):
            self.eat("[")
            unit = self.ident()
            tz = None
            self.skip_ws()
            if self.peek() == ",":
                self.eat(",")
                j = self.s.index("]", self.i)
                tz = self.s[self.i : j].strip()
                self.i = j
            self.eat("]")
            if name == "timestamp":
                return st.Timestamp(unit, tz)
            if name == "time32":
                return st.Time32(unit)
            if name == "time64":
                return st.Time64(unit)
            return st.Duration(unit)
        if name == "dictionary":
            self.eat("<")
            k = self.dtype()
            self.eat(",")
            v = self.dtype()
            self.eat(">")
            return st.Dictionary(k, v)
        if name == "list":
            self.eat("<")
            v = self.dtype()
            self.eat(">")
            return st.List(v)
        if name == "fixed_size_list":
            self.eat("<")
            v = self.dtype()
            self.eat(">")
            self.eat("[")
            n = self.int()
            self.eat("]")
            return st.FixedSizeList(v, n)
        if name == "map":
            self.eat("<")
            k = self.dtype()
            self.eat(",")
            v = self.dtype()
            self.eat(">")
            return st.Map(k, v)
        if name == "struct":
            self.eat("<")
            fields = self._fields(">")
            self.eat(">")
            return st.Struct(fields)
        if name == "union":
            self.eat("[")
            mode = self.ident()
            self.eat("]")
            self.eat("<")
            fields = self._fields(">")
            self.eat(">")
            return st.Union(fields, tuple(range(len(fields))), mode)
        if name == "run_end_encoded":
            self.eat("<")
            re_t = self.dtype()
            self.eat(",")
            v = self.dtype()
            self.eat(">")
            return st.RunEndEncoded(re_t, v)
        raise st.SchemaError(f"unknown datatype {name!r} in {self.s!r}")

    def _fields(self, close: str):
        fields = []
        self.skip_ws()
        while self.peek() != close:
            fname = self.ident()
            self.eat(":")
            fields.append(st.Field(fname, self.dtype()))
            self.skip_ws()
            if self.peek() == ",":
                self.eat(",")
                self.skip_ws()
        return tuple(fields)


def parse_datatype(s: str) -> st.DataType:
    p = _P(s)
    dt = p.dtype()
    p.skip_ws()
    if p.i != len(s):
        raise st.SchemaError(f"trailing input in datatype string {s!r}")
    return dt
