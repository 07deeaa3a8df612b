"""kernels_roofline (kernels): the least time of every launch of the
port's kernels in the traced window (kbench/roofline.py: its bytes over
the HBM bandwidth, or its operations over the float32 rate), summed, over
their summed device time from the profiler, in percent. Nothing where a
port kernel in the trace has no count or launches and spans disagree."""

from kbench.roofline import roofline_share


def read(obs):
    t = obs.traced
    if t is None or not t.device:
        return None
    return roofline_share(t.launches, t.device, **t.kernels)[0]
