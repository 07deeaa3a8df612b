"""K1 dda_job_stream: the per-(step, job) stream of R jobs over S steps,
or the keys alone on the allocation walk (kbench/roofline.py k1_bytes)."""

from kbench.roofline import k1_bytes, k1_flops, least_s

KERNELS = ("dda_kernel", "dda_kernel_keys")


def count(a):
    S, R = a["S"], a["point3"].shape[1]
    maxr = S // a["cfg"].grid.voxels_per_side + 5
    b, f = k1_bytes(R, S, maxr, bool(a["keys_only"])), k1_flops(R, S)
    return lambda: least_s(b, f)
