"""The decimated carve jobs, built and compacted to the carve budget
(csrc/carve.cu): the depth and label images and the pose's 3 x 4 words
read once; the kept jobs, 17 words and a 1-byte flag each, and `dropped`
written once. One call launches three kernels, which share the call's
least time in equal parts."""

from kbench.roofline import least_s

KERNELS = ("carve_reach_kernel", "carve_count_kernel", "carve_write_kernel")
LAUNCHES = 3


def slots(plan, H: int, W: int) -> int:
    """The job slots of `plan` at an H x W image padded to multiples of
    k_max: each chunk of a level k covers the level's (Hp/k) x (Wp/k)
    cells."""
    km = plan.k_max
    Hp, Wp = -(-H // km) * km, -(-W // km) * km
    return sum(len(ch) * (Hp // k) * (Wp // k)
               for (k, _, _), ch in zip(plan.levels, plan.chunks))


def carve_bytes(H: int, W: int, n_slots: int, budget: int) -> int:
    """A float32 depth and an int32 label a pixel, the pose's 12 words,
    min(slots, budget) jobs of 17 words and a flag, the 4-byte count."""
    return 8 * H * W + 48 + 69 * min(n_slots, budget) + 4


def count(a):
    H, W = a["depth"].shape
    b = carve_bytes(H, W, slots(a["plan"], H, W), a["budget"])
    return lambda: least_s(b) / LAUNCHES
