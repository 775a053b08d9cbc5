"""dense_agg's calls (the dense-range GROUP BY aggregate of n rows into nb
buckets, `arrowtpu_torch.kernels.dense_agg.dense_aggregate`): the least
time the bytes they need could take at the HBM's peak, over the device time
of `dense_agg_kernel`, in %.

The bytes: the key and each value column read once (n x their element
bytes), each validity bitmap read once (n / 8 bytes), and the buckets
written once: rows (nb) and four statistics a column (4 x C x nb), int64
each."""

from portbench.roofline import share

ENTRY = "arrowtpu_torch.kernels.dense_agg:dense_aggregate"
KERNELS = ("dense_agg_kernel",)


def dense_agg_bytes(n: int, key_bytes: int, key_nullable: bool,
                    value_bytes, value_nullable, buckets: int) -> int:
    read = n * (key_bytes + sum(value_bytes))
    read += -(-n // 8) * (int(key_nullable) + sum(map(int, value_nullable)))
    return read + 8 * buckets * (1 + 4 * len(value_bytes))


def call_bytes(key, key_validity, kmin, off, nb, n, values):
    values = list(values)
    return dense_agg_bytes(n, key.element_size(), key_validity is not None,
                           [v.element_size() for v, _ in values],
                           [ok is not None for _, ok in values], nb)


def read(t):
    k = t.meters["dense_agg_roofline"]
    return share(k.bytes, k.ms) if k.calls else None
