"""frame_ms.p95 (server loop): the 95th percentile of the host time of a
frame, over every frame of the measured window: hand-over to the port to
the next hand-over."""

from kbench.stats import percentile


def read(obs):
    p = percentile(obs.frame_s, 95)
    return None if p is None else 1e3 * p
