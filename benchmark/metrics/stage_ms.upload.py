"""stage_ms.upload (server loop): host ms a frame in the port's span
server/upload (models/common.py frame_from_images: the delivered host
arrays copied to the card), over the traced window (inflated by the
profiler: read it as a share)."""


def read(obs):
    t = obs.traced
    if t is None or not t.frames:
        return None
    s = t.range_s("server/upload")
    return 1e3 * s / t.frames if s > 0 else None
