"""stage_ms.band.keep (fast frame): host ms a frame in the port's span
integrate_frame/band/keep (the thinning salt, the octave keep, the ray
budget's count and the compaction of the kept pixels), over the traced
window (inflated by the profiler: read it as a share of stage_ms.band)."""


def read(obs):
    t = obs.traced
    if t is None or not t.frames:
        return None
    s = t.range_s("integrate_frame/band/keep")
    return 1e3 * s / t.frames if s > 0 else None
