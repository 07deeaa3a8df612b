"""syncs_per_frame (server loop): the CUDA runtime and driver calls that
make the host wait on the device, by the port's own witness
(utils/syncs.py is_host_sync), over the traced window's frames."""


def read(obs):
    t = obs.traced
    if t is None or not t.frames or not t.device:
        return None
    return t.count(obs.is_host_sync) / t.frames
