"""K5 block_rmw_add: the live tiles' delta rows and the grid words of
their nonzero deltas (kbench/roofline.py k5_bytes). What is nonzero is
reduced on the device at the launch and read after the window."""

import torch

from kbench.roofline import k5_bytes, least_s

KERNELS = ("block_rmw_kernel", "block_rmw_kernel_generic")


def count(a):
    wsum, slots, d_w, d_cnt = a["wsum"], a["slots"], a["d_w"], a["d_cnt"]
    d_sem = a["d_sem"]
    rows_total, V3 = wsum.shape
    K = slots.shape[0]
    groups = torch.div(slots[::8], 8, rounding_mode="floor")
    live_t = (groups >= 0) & (groups < (rows_total - 8) // 8)
    live = live_t.repeat_interleave(8)[:K]
    planes = d_sem.shape[0] if d_sem is not None else 1
    nz = torch.stack([
        live_t.sum() * 8,
        ((d_w != 0) & live[:, None]).sum(),
        ((d_cnt != 0) & live[:, None]).sum(),
        ((d_sem > 0) & live[None, :, None]).sum() if d_sem is not None
        else ((d_cnt != 0) & live[:, None]).sum()])
    colour = a["d_wc"] is not None

    def thunk():
        r, w, c, v = (int(x) for x in nz.tolist())
        return least_s(k5_bytes(r, V3, planes, colour, w, c, v),
                       2 * w + c + v)
    return thunk
