"""Compton reflection of the port (cr_sent 1-4) against the JAX package:
the reflection sampler fed the reference's own uniforms, and the whole
boundary handler ``_leak`` for every cr_sent and spec_switch on a
hand-built photon state with lanes at every boundary, with the five
uniforms the reference's ``_leak`` draws from its two keys."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compton2d_tpu import config as jcfg
from compton2d_tpu import tables as jtables
from compton2d_tpu.state import EventBuffer as JEvents
from compton2d_tpu.state import PhotonArray as JPhotons
from compton2d_tpu.state import Tallies as JTallies
from compton2d_tpu.transport import tracking as jtr
from compton2d_tpu.transport.geometry import FlightGeom
from compton2d_tpu_torch import convert
from compton2d_tpu_torch import config as pcfg
from compton2d_tpu_torch import tables as ptables
from compton2d_tpu_torch.state import EventBuffer as PEvents
from compton2d_tpu_torch.state import PhotonArray as PPhotons
from compton2d_tpu_torch.state import Tallies as PTallies
from compton2d_tpu_torch.transport import flight
from compton2d_tpu_torch.transport import tracking as ptr

torch.set_num_threads(2)

NZ, NR, N = 3, 2, 4096
N_REF = 100
GRID = dict(nz=NZ, nr=NR, num_nt=50, n_vol=64, nphfield=64, n_gg=32,
            n_ref=N_REF, nmu=4,
            spectral_regions=((1e-4, 1e-1, 20), (1e-1, 1e4, 40)),
            lc_bands=((2.0, 10.0), (10.0, 50.0)))
K1, K2 = jax.random.split(jax.random.PRNGKey(11))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _uniforms(k1, k2, n=N):
    """The uniforms the reference's _leak draws, in LeakDraws' order."""
    f = jax.random.fold_in
    keys = (k1, k2, f(k1, 1), f(k2, 1), f(k1, 2))
    return ptr.LeakDraws(*(_t(jax.random.uniform(k, (n,), jnp.float32))
                           for k in keys))


@pytest.fixture(scope="module")
def ctxs():
    tj = jtables.build_tables(jcfg.GridConfig(**GRID), 1.0)
    nzr = NZ * NR
    tbbl = np.array([True, False])   # ring 0 samples, ring 1 mirrors
    jctx = jtr.TrackContext(
        r_edges=jnp.linspace(0.0, 1.0, NR + 1),
        z_edges=jnp.linspace(0.0, 1.0, NZ + 1),
        opac_zone=jnp.ones((nzr, 64, 2)), kgg_zone=jnp.zeros((nzr, 32)),
        cdf_nt=jnp.ones((nzr, 50)), gnt=tj.gnt,
        e_ph_log0=tj.e_ph_log0, e_ph_dlog=tj.e_ph_dlog,
        e_gg_log0=tj.e_gg_log0, e_gg_dlog=tj.e_gg_dlog,
        e_field_log0=jnp.log(tj.e_field[0]),
        e_field_dlog=jnp.log(tj.e_field[1] / tj.e_field[0]),
        hu=tj.hu, mu_edges=tj.mu_edges, lc_lo=tj.lc_lo, lc_hi=tj.lc_hi,
        e_ref=tj.e_ref, p_ref_t=tj.p_ref.T, w_abs_t=tj.w_abs.T,
        tbbl_pos=jnp.asarray(tbbl), inv_nsigt=jnp.ones(nzr),
        time=jnp.float32(1.5e4), dt=jnp.float32(3.3e3),
        inv_c=jnp.float32(1e15 / 2.998e10),
    )
    e_ref, p_ref_t, w_abs_t = convert.track_reflection(
        convert.flatten(jctx), device="cpu")
    pctx = ptr.TrackContext(
        r_edges=_t(jctx.r_edges), z_edges=_t(jctx.z_edges),
        opac_zone=_t(jctx.opac_zone), cdf_nt=_t(jctx.cdf_nt),
        gnt=_t(tj.gnt), e_ph_log0=float(jctx.e_ph_log0),
        e_ph_dlog=float(jctx.e_ph_dlog),
        e_gg_log0=_t(jctx.e_gg_log0), e_gg_dlog=_t(jctx.e_gg_dlog),
        e_field_log0=_t(jctx.e_field_log0),
        e_field_dlog=_t(jctx.e_field_dlog), hu=_t(tj.hu),
        mu_edges=_t(tj.mu_edges), lc_lo=_t(tj.lc_lo), lc_hi=_t(tj.lc_hi),
        tbbl_pos=_t(tbbl), time=_t(jctx.time), dt=_t(jctx.dt),
        inv_c=float(jctx.inv_c), e_ref=e_ref, p_ref_t=p_ref_t,
        w_abs_t=w_abs_t,
        guide_u=torch.as_tensor(flight.guide_u_edges()),
        e_gg_host=(float(jctx.e_gg_log0), float(jctx.e_gg_dlog)),
        strat_frac=ptr.strat_fractions(1),
    )
    return jctx, pctx


def test_reflection_tables_match_the_reference_context(ctxs):
    """The tables the driver hands the tracker (the port's e_ref and its
    P_ref, w_abs transposed) equal the reference TrackContext's, bit for
    bit: the reference indexes its transposes, the port's Tables hold
    P_ref and w_abs as (n_out, n_in)."""
    _, pctx = ctxs
    tp = ptables.build_tables(pcfg.GridConfig(**GRID), 1.0)
    for mine, ref in ((tp.e_ref, pctx.e_ref), (tp.p_ref.T, pctx.p_ref_t),
                      (tp.w_abs.T, pctx.w_abs_t)):
        assert torch.equal(mine.contiguous(), ref)


def _photons(seed, e_range=(-5.0, 5.0)):
    rng = np.random.default_rng(seed)
    phi = rng.uniform(0, 2 * np.pi, N)
    d = dict(
        e=10.0 ** rng.uniform(*e_range, N), w=rng.gamma(0.5, 1.0, N),
        w0=np.ones(N), r=rng.uniform(0, 1, N), z=rng.uniform(0, 1, N),
        mu=rng.uniform(-1, 1, N), cphi=np.cos(phi), sphi=np.sin(phi),
        dcen=rng.uniform(0, 0.1, N),
    )
    d = {k: v.astype(np.float32) for k, v in d.items()}
    d["mu"][:50] = 0.99       # above the upper-escape event cut
    d["mu"][50:60] = 0.0      # level lanes at the outer radius
    d["jz"] = rng.integers(0, NZ, N).astype(np.int32)
    d["kr"] = rng.integers(0, NR, N).astype(np.int32)
    d["alive"] = rng.uniform(size=N) < 0.9
    return d


def _pair(d):
    return (JPhotons(**{k: jnp.asarray(v) for k, v in d.items()}),
            PPhotons(**{k: _t(v) for k, v in d.items()}))


def test_sampler_matches_reference(ctxs):
    """Every lane at a thermal lower ring under cr_sent 1: the reference's
    _leak samples each one, and the port's sample_reflection, fed the same
    uniforms, gives the same energies and weights (rtol 1e-6: equal bins,
    one lerp and three products in float32; 100% of lanes within it)."""
    jctx, pctx = ctxs
    d = _photons(4, e_range=(-0.5, 3.5))   # around the 1-1000 keV grid
    d["alive"][:] = True
    d["kr"][:] = 0
    jph, pph = _pair(d)
    jn = np.full(N, -1, np.int32)
    kn = d["kr"].copy()
    g = FlightGeom(trldb=jnp.zeros(N), jnew=jnp.asarray(jn),
                   knew=jnp.asarray(kn), rbnd=jph.r, zbnd=jph.z)
    tl_j = JTallies.zeros(NZ, NR, 50, 64, 32, 4, 60, 2)
    phj, tlj, _ = jtr._leak(jph, tl_j, JEvents.empty(64),
                            jnp.ones(N, bool), g, jctx,
                            jtr.TrackStatics(nz=NZ, nr=NR, cr_sent=1),
                            K1, K2)
    u = _uniforms(K1, K2)
    e_new, w_new = ptr.sample_reflection(
        pph.e, pph.w, u.u_cdf_low, u.u_e_low, pctx.e_ref, pctx.p_ref_t,
        pctx.w_abs_t)
    np.testing.assert_allclose(_np(e_new), _np(phj.e), rtol=1e-6)
    np.testing.assert_allclose(_np(w_new), _np(phj.w), rtol=1e-6)
    # the draws span the grid: pass-through below 20 keV and reflection
    assert np.sum(_np(e_new) < 20.0) > 100 and np.sum(_np(e_new) > 20) > 100
    np.testing.assert_allclose(float(np.sum(_np(tlj.ed_ref))),
                               float(torch.sum(w_new)), rtol=1e-5)


@pytest.mark.parametrize("spec_switch", [0, 1])
@pytest.mark.parametrize("cr_sent", [0, 1, 2, 3, 4])
def test_leak_matches_reference(ctxs, cr_sent, spec_switch):
    """The whole boundary handler, lanes at every boundary, ring 0 of the
    lower boundary thermal (sampled reflection) and ring 1 not (mirrored):
    photon fields rtol 1e-6, integer fields and the alive mask exact;
    erlk_*, ed_in, ed_ref, fout and edout rtol 1e-6 of each array's scale
    (the port sums each segment in slot order, the reference by one-hot
    matmul: a sum-order tolerance); event records in the same slot order,
    rtol 1e-6 (atan2 may differ in the last bit)."""
    jctx, pctx = ctxs
    d = _photons(1)
    rng = np.random.default_rng(2)
    mask = d["alive"] & (rng.uniform(size=N) < 0.5)
    side = rng.integers(0, 4, N)
    jn = np.where(side == 2, -1, np.where(side == 3, NZ, d["jz"]))
    kn = np.where(side == 0, -1, np.where(side == 1, NR, d["kr"]))
    jn, kn = jn.astype(np.int32), kn.astype(np.int32)
    jph, pph = _pair(d)
    args = (NZ, NR, 50, 64, 32, 4, 60, 2)
    tl_j, tl_p = JTallies.zeros(*args), PTallies.zeros(*args)
    ev_j = JEvents.empty(8192)._replace(count=jnp.array([3], jnp.int32))
    ev_p = PEvents.empty(8192)._replace(
        count=torch.tensor([3], dtype=torch.int32))
    g = FlightGeom(trldb=jnp.zeros(N), jnew=jnp.asarray(jn),
                   knew=jnp.asarray(kn), rbnd=jph.r, zbnd=jph.z)
    st_j = jtr.TrackStatics(nz=NZ, nr=NR, cr_sent=cr_sent,
                            spec_switch=spec_switch)
    st_p = ptr.TrackStatics(nz=NZ, nr=NR, cr_sent=cr_sent,
                            spec_switch=spec_switch)
    phj, tlj, evj = jtr._leak(jph, tl_j, ev_j, jnp.asarray(mask), g, jctx,
                              st_j, K1, K2)
    php, tlp, evp = ptr._leak(pph, tl_p, ev_p, _t(mask), _t(jn), _t(kn),
                              pctx, st_p, _uniforms(K1, K2))
    for name in ("jz", "kr", "alive"):
        np.testing.assert_array_equal(_np(getattr(php, name)),
                                      _np(getattr(phj, name)), err_msg=name)
    for name in ("e", "w", "w0", "r", "z", "mu", "cphi", "sphi", "dcen"):
        np.testing.assert_allclose(_np(getattr(php, name)),
                                   _np(getattr(phj, name)), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    for name in ("erlk_inner", "erlk_outer", "erlk_upper", "erlk_lower",
                 "ed_in", "ed_ref", "fout", "edout"):
        ref = _np(getattr(tlj, name))
        np.testing.assert_allclose(_np(getattr(tlp, name)), ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(ref).max(),
                                   err_msg=name)
    assert int(evp.count[0]) == int(evj.count[0]) > 300
    np.testing.assert_allclose(_np(evp.data), _np(evj.data), rtol=1e-6,
                               atol=1e-6)

    at_lower = mask & (jn < 0) & (kn >= 0) & (kn < NR)
    at_outer = mask & (kn >= NR)
    n_low = int(np.sum(at_lower)) if cr_sent in (1, 3, 4) else 0
    n_disk = (int(np.sum(at_outer & (d["mu"] <= 0.0)))
              if cr_sent in (2, 3) else 0)
    assert int(tlp.n_reflect_lower) == n_low
    assert int(tlp.n_reflect_disk) == n_disk
    if cr_sent in (1, 3, 4):
        # reflected lanes turn upward into row 0 and stay alive
        refl = _np(php.alive) & at_lower
        assert refl.sum() == n_low > 100
        assert np.all(_np(php.mu)[refl] >= 0.0)
        assert np.all(_np(php.jz)[refl] == 0)
        assert (float(torch.sum(tlp.ed_ref)) > 0.0) == (cr_sent != 4)
    if cr_sent in (2, 3):
        assert n_disk > 100
