"""stage_ms.band: host ms a frame in the port's profiler range
integrate_frame/band, over the traced window (inflated by the profiler:
read it as a share)."""


def read(obs):
    t = obs.traced
    if t is None or not t.frames:
        return None
    s = t.range_s("integrate_frame/band")
    return 1e3 * s / t.frames if s > 0 else None
