"""The port's boundary handler ``_leak`` (cr_sent=0), census tallies,
binning and segment sums against the JAX reference on identical inputs.
Event records must come out in the same order."""
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
from compton2d_tpu_torch.state import EventBuffer as PEvents
from compton2d_tpu_torch.state import PhotonArray as PPhotons
from compton2d_tpu_torch.state import Tallies as PTallies
from compton2d_tpu_torch.transport import flight
from compton2d_tpu_torch.transport import tracking as ptr

torch.set_num_threads(2)

NZ, NR, N = 3, 2, 2048
GRID = dict(nz=NZ, nr=NR, num_nt=50, n_vol=64, nphfield=64, n_gg=32,
            n_ref=100, nmu=4,
            spectral_regions=((1e-4, 1e-1, 20), (1e-1, 1e4, 40)),
            lc_bands=((2.0, 10.0), (10.0, 50.0)))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def ctxs():
    tj = jtables.build_tables(jcfg.GridConfig(**GRID), 1.0)
    nzr = NZ * NR
    tbbl = np.array([True, False])
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
        inv_c=float(jctx.inv_c),
        guide_u=torch.as_tensor(flight.guide_u_edges()),
        e_gg_host=(float(jctx.e_gg_log0), float(jctx.e_gg_dlog)),
        strat_frac=ptr.strat_fractions(1),
    )
    return jctx, pctx


def _photons(seed):
    rng = np.random.default_rng(seed)
    phi = rng.uniform(0, 2 * np.pi, N)
    d = dict(
        e=10.0 ** rng.uniform(-5.0, 5.0, N), w=rng.gamma(0.5, 1.0, N),
        w0=np.ones(N), r=rng.uniform(0, 1, N), z=rng.uniform(0, 1, N),
        mu=rng.uniform(-1, 1, N), cphi=np.cos(phi), sphi=np.sin(phi),
        dcen=rng.uniform(0, 0.1, N),
    )
    d = {k: v.astype(np.float32) for k, v in d.items()}
    d["mu"][:50] = 0.99   # above the upper-escape event cut
    d["jz"] = rng.integers(0, NZ, N).astype(np.int32)
    d["kr"] = rng.integers(0, NR, N).astype(np.int32)
    d["alive"] = rng.uniform(size=N) < 0.9
    return d


def _tallies():
    args = (NZ, NR, 50, 64, 32, 4, 60, 2)
    return JTallies.zeros(*args), PTallies.zeros(*args)


@pytest.mark.parametrize("rmin_positive,capacity", [(False, 4096),
                                                    (True, 256)])
def test_leak_matches_reference(ctxs, rmin_positive, capacity):
    """Tallies rtol 1e-5; photon state exact; event records in the same
    slot order (rtol 1e-6: atan2 may differ in the last bit), including
    the capacity cut."""
    jctx, pctx = ctxs
    d = _photons(1)
    rng = np.random.default_rng(2)
    mask = d["alive"] & (rng.uniform(size=N) < 0.4)
    exit_side = rng.integers(0, 4, N)
    jn = np.where(exit_side == 2, -1, np.where(exit_side == 3, NZ, d["jz"]))
    kn = np.where(exit_side == 0, -1, np.where(exit_side == 1, NR, d["kr"]))
    jn, kn = jn.astype(np.int32), kn.astype(np.int32)
    tl_j, tl_p = _tallies()
    ev_j = JEvents.empty(capacity)._replace(count=jnp.array([7], jnp.int32))
    ev_p = PEvents.empty(capacity)._replace(
        count=torch.tensor([7], dtype=torch.int32))
    jph = JPhotons(**{k: jnp.asarray(v) for k, v in d.items()})
    pph = PPhotons(**{k: _t(v) for k, v in d.items()})
    g = FlightGeom(trldb=jnp.zeros(N), jnew=jnp.asarray(jn),
                   knew=jnp.asarray(kn), rbnd=jph.r, zbnd=jph.z)
    st_j = jtr.TrackStatics(nz=NZ, nr=NR, rmin_positive=rmin_positive)
    st_p = ptr.TrackStatics(nz=NZ, nr=NR, rmin_positive=rmin_positive)
    k = jax.random.PRNGKey(0)
    phj, tlj, evj = jtr._leak(jph, tl_j, ev_j, jnp.asarray(mask), g, jctx,
                              st_j, k, k)
    php, tlp, evp = ptr._leak(pph, tl_p, ev_p, _t(mask), _t(jn), _t(kn),
                              pctx, st_p)
    for name in ("cphi", "sphi", "kr", "alive", "w", "e"):
        np.testing.assert_array_equal(_np(getattr(php, name)),
                                      _np(getattr(phj, name)), err_msg=name)
    for name in ("erlk_inner", "erlk_outer", "erlk_upper", "erlk_lower",
                 "ed_in", "fout", "edout"):
        ref = _np(getattr(tlj, name))
        np.testing.assert_allclose(_np(getattr(tlp, name)), ref, rtol=1e-5,
                                   atol=1e-6 * np.abs(ref).max(),
                                   err_msg=name)
    # over 300 records: capacity 256 overflows, 4096 holds them all
    assert int(evp.count[0]) == int(evj.count[0]) > 300
    np.testing.assert_allclose(_np(evp.data), _np(evj.data), rtol=1e-6)


def test_census_tally_matches_reference(ctxs):
    jctx, pctx = ctxs
    d = _photons(3)
    tl_j, tl_p = _tallies()
    jph = JPhotons(**{k: jnp.asarray(v) for k, v in d.items()})
    pph = PPhotons(**{k: _t(v) for k, v in d.items()})
    out_j = jtr.census_tally(jph, tl_j, jctx, jtr.TrackStatics(nz=NZ, nr=NR))
    out_p = ptr.census_tally(pph, tl_p, pctx, ptr.TrackStatics(nz=NZ, nr=NR))
    for name in ("ecens", "npcen", "n_field", "n_ph"):
        ref = _np(getattr(out_j, name))
        np.testing.assert_allclose(_np(getattr(out_p, name)), ref, rtol=1e-5,
                                   atol=1e-6 * np.abs(ref).max(),
                                   err_msg=name)


def test_binning_matches_reference(ctxs):
    jctx, pctx = ctxs
    rng = np.random.default_rng(4)
    e = (10.0 ** rng.uniform(-6.0, 6.0, 5000)).astype(np.float32)
    e[:3] = [2.0, 10.0, 50.0]                    # light-curve band edges
    mu = rng.uniform(-1, 1, 5000).astype(np.float32)
    mu[:4] = np.asarray(jctx.mu_edges)           # angular bin edges
    np.testing.assert_array_equal(
        _np(ptr.spectral_bin(pctx.hu, _t(e))),
        _np(jtr.spectral_bin(jctx.hu, jnp.asarray(e))))
    np.testing.assert_array_equal(
        _np(ptr.lc_bin(pctx.lc_lo, pctx.lc_hi, _t(e))),
        _np(jtr.lc_bin(jctx.lc_lo, jctx.lc_hi, jnp.asarray(e))))
    np.testing.assert_array_equal(
        _np(ptr.mu_bin(pctx.mu_edges, _t(mu))),
        _np(jtr.mu_bin(jctx.mu_edges, jnp.asarray(mu))))
    for a, b in zip(
            ptr.loggrid_bin(_t(e), pctx.e_field_log0, pctx.e_field_dlog, 64),
            jtr.loggrid_bin(jnp.asarray(e), jctx.e_field_log0,
                            jctx.e_field_dlog, 64)):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_segment_sums_match_scatter_add():
    """segment_sum / hist2d against a float64 np.add.at to float32
    accumulation accuracy (the bound the reference's own one-hot tally
    test uses), and bitwise repeatable."""
    n, nzr, nb = 20000, 37, 9
    rng = np.random.default_rng(0)
    vals = rng.gamma(0.3, size=n).astype(np.float32)
    zid = rng.integers(0, nzr, n).astype(np.int32)
    bins = rng.integers(0, nb, n).astype(np.int32)
    ref = np.zeros((nzr, nb))
    np.add.at(ref, (zid, bins), vals.astype(np.float64))
    got = _np(ptr.hist2d(_t(vals), _t(zid), nzr, _t(bins), nb))
    assert (np.abs(got - ref) / ref)[ref > 0].max() < 5e-6
    s1 = ptr.segment_sum(_t(vals), _t(zid), nzr)
    s2 = ptr.segment_sum(_t(vals), _t(zid), nzr)
    assert torch.equal(s1, s2)
    np.testing.assert_allclose(_np(s1), ref.sum(1), rtol=5e-6)
