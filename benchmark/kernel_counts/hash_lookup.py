"""H1 hash_lookup: one slot a key (kbench/roofline.py h1_bytes)."""

from kbench.roofline import h1_bytes, least_s

KERNELS = ("hash_lookup_kernel",)


def count(a):
    b = h1_bytes(a["keys"].shape[0])
    return lambda: least_s(b)
