"""syncs_undeclared_per_frame (server loop): the host syncs (the CUDA
calls that the port's witness utils/syncs.py is_host_sync names) that
start inside a span of the port but inside none of its sync/ spans, per
traced frame. A sync inside no span of the port, such as the harness's
own synchronize at the end of its drive, is not counted. The profiler
records the spans and calls of the thread that started it. Nothing where
the trace holds no server/frame span: a port that does not declare its
syncs."""

PORT_SPANS = ("server/", "integrate_frame/", "integrate/", "mesh/", "esdf/",
              "icp/", "kernels/", "sync/")


def read(obs):
    t = obs.traced
    if t is None or not t.frames or not t.device:
        return None
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in t.host
             if e.name.startswith(PORT_SPANS)]
    if not any(name == "server/frame" for _, _, name in spans):
        return None
    declared = [(a, b) for a, b, name in spans if name.startswith("sync/")]
    n = 0
    for e in t.host:
        if not obs.is_host_sync(e.name):
            continue
        x = e.time_range.start
        if any(a <= x <= b for a, b, _ in spans) and \
                not any(a <= x <= b for a, b in declared):
            n += 1
    return n / t.frames
