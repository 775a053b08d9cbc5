"""File and interchange formats: the Arrow physical layout (`layout`),
the Arrow IPC stream and file formats (`ipc`, over `flatbuf` and the
`lz4` frame codec), and the Parquet family: `parquet` (reader and writer
over `thrift`), `parquet_ext` (bloom filters, delta encodings, the page
index), `parquet_scan` (pushdown), `parquet_push` (sans-IO decoder),
`parquet_record` (rows), `parquet_nested` (Dremel levels), `parquet_cdc`
(content-defined pages), `parquet_crypto` (modular encryption) and
`geospatial` (WKB statistics); the row formats `csv`, `json` and `avro`
(with its native block decoders); and `snappy`, Avro's snappy codec."""

from . import layout  # noqa: F401
from .avro import AvroFile, read_avro, write_avro  # noqa: F401
from .csv import read_csv, write_csv  # noqa: F401
from .json import read_json, write_json  # noqa: F401
