"""exchange_ms: milliseconds a step that the rank which waits longest
spends in the mesh's exchanges (``PhotonMesh.comm_s``: host clock around
each all_gather, the wait for the other ranks included)."""


def read(m):
    if m.world < 2:
        return None
    return 1e3 * m.comm_s / m.steps
