"""stage_ms.band.carve_jobs (fast frame): host ms a frame in the port's
span integrate_frame/band/carve_jobs (the carve plan, the decimated carve
jobs level by level and chunk by chunk, and their compaction to the carve
budget), over the traced window (inflated by the profiler: read it as a
share of stage_ms.band)."""


def read(obs):
    t = obs.traced
    if t is None or not t.frames:
        return None
    s = t.range_s("integrate_frame/band/carve_jobs")
    return 1e3 * s / t.frames if s > 0 else None
