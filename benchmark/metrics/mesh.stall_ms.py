"""mesh.stall_ms (mesh cycle): ms a frame that the stream waited on a mesh
cycle still in flight when the next was due (the server's mesh_stall_s),
over the measured window."""


def read(obs):
    if not obs.mesh_cycle_s:
        return None
    return 1e3 * obs.mesh_stall_s / obs.frames
