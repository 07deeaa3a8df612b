"""sync_ms.wait (server loop): host ms a frame inside the port's sync/
spans, each around one statement that makes the host wait for the device
(utils/timing.py): the host's wait for the device to drain, over the
traced window (inflated by the profiler: read it as a share)."""


def read(obs):
    t = obs.traced
    if t is None or not t.frames or not t.device:
        return None
    us = sum(e.time_range.elapsed_us() for e in t.host
             if e.name.startswith("sync/"))
    return us / 1e3 / t.frames if us > 0 else None
