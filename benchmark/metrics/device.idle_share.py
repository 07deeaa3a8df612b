"""device.idle_share (device): 100 less the percent of the traced window in
which the device ran any operation (the union of its spans)."""


def read(obs):
    t = obs.traced
    if t is None or not t.device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
