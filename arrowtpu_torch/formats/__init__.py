"""File and interchange formats: the Arrow physical layout (`layout`),
the Arrow IPC stream and file formats (`ipc`, over `flatbuf` and the
`lz4` frame codec), and the Parquet family's host codecs (`thrift`,
`snappy`)."""

from . import layout
