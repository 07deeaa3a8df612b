"""K6 slot_resolve_stream: an (S, R) stream's slots resolved against the
camera cube (kbench/roofline.py k6_bytes)."""

from kbench.roofline import k6_bytes, least_s

KERNELS = ("slot_resolve_kernel",)


def count(a):
    S, R = a["local"].shape
    b = k6_bytes(R, S, a["run_key"].shape[0])
    return lambda: least_s(b)
