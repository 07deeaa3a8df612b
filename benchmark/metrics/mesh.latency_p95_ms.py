"""mesh.latency_p95_ms (mesh cycle): the 95th percentile of a pipelined
mesh cycle's dispatch-to-collected time (the server's mesh_cycle_s), over
the cycles of the measured window."""

from kbench.stats import percentile


def read(obs):
    p = percentile(obs.mesh_cycle_s, 95)
    return None if p is None else 1e3 * p
