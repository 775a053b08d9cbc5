"""File and interchange formats: the Arrow physical layout (`layout`),
the Arrow IPC stream and file formats (`ipc`, over `flatbuf` and the
`lz4` frame codec), and the Parquet family: `parquet` (reader and writer
over `thrift`), `parquet_ext` (bloom filters, delta encodings, the page
index), `parquet_scan` (pushdown), `parquet_push` (sans-IO decoder),
`parquet_record` (rows), `parquet_nested` (Dremel levels), `parquet_cdc`
(content-defined pages) and `parquet_crypto` (modular encryption); and
`snappy`, which the Parquet reader does not use yet."""

from . import layout
