"""H2 hash_insert: the table and the block coordinates rewritten once
(kbench/roofline.py h2_bytes)."""

from kbench.roofline import h2_bytes, least_s

KERNELS = ("hash_insert_kernel_smem", "hash_insert_kernel")


def count(a):
    b = h2_bytes(a["table_keys"].shape[0], a["block_coords"].shape[0],
                 a["keys"].shape[0])
    return lambda: least_s(b)
