"""The port's flight geometry (``transport/geometry.py``) against the JAX
reference's ``compton2d_tpu.transport.geometry`` on the same photons:
4096 photons of a 6x5 grid with non-uniform edges, among them lanes on
the axis, inward rays that pass inside the inner shell, and |mu| within
1e-7 of 1. Floats rtol 1e-5 on at least 99.9% of the lanes (torch's and
XLA's sqrt and division may differ in the last bit, and a chord that
cancels to 0 amplifies it), new zone ids exact."""
import jax.numpy as jnp
import numpy as np
import torch

from compton2d_tpu.transport import geometry as jgeo
from compton2d_tpu_torch.transport import geometry as pgeo

N, NZ, NR = 4096, 6, 5


def _photons(seed=0):
    rng = np.random.default_rng(seed)
    r_edges = np.concatenate([[0.0], np.cumsum(rng.uniform(0.5, 1.5, NR))])
    z_edges = np.concatenate([[0.0], np.cumsum(rng.uniform(0.5, 1.5, NZ))])
    kr = rng.integers(0, NR, N)
    jz = rng.integers(0, NZ, N)
    u = rng.uniform(0.0, 1.0, N)
    r = r_edges[kr] + u * (r_edges[kr + 1] - r_edges[kr])
    z = z_edges[jz] + rng.uniform(0.0, 1.0, N) * (z_edges[jz + 1]
                                                  - z_edges[jz])
    mu = rng.uniform(-1.0, 1.0, N)
    phi = rng.uniform(-np.pi, np.pi, N)
    # lanes on the axis (r = 0, zone 0 of r), on the inner and outer
    # shells, inward rays of the outer zones, and |mu| near 1
    r[:64], kr[:64] = 0.0, 0
    r[64:128] = r_edges[kr[64:128]]
    r[128:192] = r_edges[kr[128:192] + 1]
    kr[192:320] = rng.integers(1, NR, 128)
    r[192:320] = r_edges[kr[192:320]] + 0.3 * (r_edges[kr[192:320] + 1]
                                               - r_edges[kr[192:320]])
    phi[192:320] = np.pi + rng.uniform(-0.3, 0.3, 128)
    mu[320:384] = np.where(rng.uniform(size=64) < 0.5, 1.0, -1.0) * (
        1.0 - 10.0 ** rng.uniform(-7, -3, 64))
    mu[384:400] = np.sign(rng.uniform(-1, 1, 16))
    f = np.float32
    return dict(r=r.astype(f), z=z.astype(f), mu=mu.astype(f),
                cphi=np.cos(phi).astype(f), sphi=np.sin(phi).astype(f),
                jz=jz.astype(np.int32), kr=kr.astype(np.int32),
                r_edges=r_edges.astype(f), z_edges=z_edges.astype(f))


def _mostly_close(a, b, name):
    ok = np.isclose(a, b, rtol=1e-5, atol=1e-6)
    assert ok.mean() >= 0.999, (name, ok.mean(), np.flatnonzero(~ok)[:10])


def test_distance_to_boundary_matches_reference():
    d = _photons()
    gj = jgeo.distance_to_boundary(**{k: jnp.asarray(v) for k, v in d.items()})
    gp = pgeo.distance_to_boundary(**{k: torch.as_tensor(v)
                                      for k, v in d.items()})
    for name in ("jnew", "knew"):
        assert getattr(gp, name).dtype == torch.int32
        np.testing.assert_array_equal(getattr(gp, name).numpy(),
                                      np.asarray(getattr(gj, name)),
                                      err_msg=name)
    for name in ("trldb", "rbnd", "zbnd"):
        _mostly_close(getattr(gp, name).numpy(),
                      np.asarray(getattr(gj, name)), name)
    # the special lanes all reach a boundary at a finite distance
    assert np.all(np.isfinite(gp.trldb.numpy()))
    assert np.all(gp.trldb.numpy() >= 0.0)


def test_advance_matches_reference():
    d = _photons(1)
    rng = np.random.default_rng(2)
    trld = rng.uniform(0.0, 2.0, N).astype(np.float32)
    trld[:16] = 0.0
    keys = ("r", "z", "mu", "cphi", "sphi")
    free_j = jgeo.advance(*(jnp.asarray(d[k]) for k in keys),
                          jnp.asarray(trld))
    free_p = pgeo.advance(*(torch.as_tensor(d[k]) for k in keys),
                          torch.as_tensor(trld))
    # the move pinned to the boundary point of distance_to_boundary
    g = jgeo.distance_to_boundary(**{k: jnp.asarray(v) for k, v in d.items()})
    pin_j = jgeo.advance(*(jnp.asarray(d[k]) for k in keys), g.trldb,
                         rnew=g.rbnd, znew=g.zbnd)
    pin_p = pgeo.advance(*(torch.as_tensor(d[k]) for k in keys),
                         torch.as_tensor(np.asarray(g.trldb)),
                         rnew=torch.as_tensor(np.asarray(g.rbnd)),
                         znew=torch.as_tensor(np.asarray(g.zbnd)))
    for label, p, j in (("free", free_p, free_j), ("pinned", pin_p, pin_j)):
        for name, a, b in zip(("r", "z", "cphi", "sphi"), p, j):
            _mostly_close(a.numpy(), np.asarray(b), f"{label} {name}")
        # a unit vector, except on the axis (a lane at r = 0 that does
        # not move keeps no azimuth, in both codes)
        off_axis = p[0].numpy() > 1e-6
        c, s = p[2].numpy()[off_axis], p[3].numpy()[off_axis]
        np.testing.assert_allclose(c * c + s * s, 1.0, atol=1e-5)
