"""Run options of the port against the JAX package: the coronal flare's
boost of the zones the FP solve sees, the adaptive-dt rule on an injected
dt_new (ncycle 0 and the dt_min guard included), and run_to_stop under
adaptive dt with the host clock mirror (after tests/test_runloop.py's
adaptive-dt cases)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import compton2d_tpu.driver as jdrv
import compton2d_tpu_torch.driver as pdrv
from compton2d_tpu import config as jcfg
from compton2d_tpu import examples as jex
from compton2d_tpu_torch import config as pcfg
from compton2d_tpu_torch import examples as pex

torch.set_num_threads(2)

TINY = dict(nz=3, nr=2, nst=300, n_slots=1024, num_nt=40, n_vol=32,
            nphfield=32, t_const=False)


def _pair(run=None, physics=None, **kw):
    """The reference's and the port's small corona with the same config."""
    js = jex.small_corona(**{**TINY, **kw})
    ps = pex.small_corona(**{**TINY, **kw}, device="cpu")
    out = []
    for sim, cfg in ((js, jcfg), (ps, pcfg)):
        c = sim.cfg
        if run:
            c = c.replace(run=dataclasses.replace(c.run, **run))
        if physics:
            fl = physics.get("flare")
            ph = dict(physics)
            if fl is not None:
                ph["flare"] = cfg.FlareConfig(**fl)
            c = c.replace(physics=dataclasses.replace(c.physics, **ph))
        out.append(sim.with_config(c))
    return out


def _patch(monkeypatch, j_wrap, p_wrap):
    j_fp, p_fp = jdrv.fp_step, pdrv.fp_step
    monkeypatch.setattr(jdrv, "fp_step", lambda *a, **k: j_wrap(j_fp, a, k))
    monkeypatch.setattr(pdrv, "fp_step", lambda *a, **k: p_wrap(p_fp, a, k))


def test_flare_boost_matches_reference(monkeypatch):
    """The zones handed to fp_step under a flare (turb_lev + A g, tna (1 +
    A g), g Gaussian in r, z [cm] and time [s]) at four steps around the
    peak, rtol 1e-6 against what the reference hands its fp_step; the
    boost is the FP solve's alone: the zones after the step keep tna and
    turb_lev."""
    dt0 = 0.3 * min(1e15 / 3, 1e15 / 2) / 2.99792458e10
    fl = dict(enabled=True, r_flare=0.3e15, z_flare=0.5e15,
              t_flare=2.0 * dt0, sigma_r=0.3e15, sigma_z=0.25e15,
              sigma_t=1.5 * dt0, amplitude=2.0)
    js, ps = _pair(physics=dict(flare=fl))
    seen_j, seen_p = [], []

    def j_wrap(fp, a, k):
        jax.debug.callback(
            lambda tl, tn: seen_j.append((np.asarray(tl), np.asarray(tn))),
            a[0].turb_lev, a[0].tna)
        return fp(*a, **k)

    def p_wrap(fp, a, k):
        seen_p.append((a[0].turb_lev.numpy().copy(),
                       a[0].tna.numpy().copy()))
        return fp(*a, **k)

    _patch(monkeypatch, j_wrap, p_wrap)
    for _ in range(4):
        js.step()
        ps.step()
        # the flare's zones are ephemeral
        assert np.all(np.asarray(js.state.zones.turb_lev) == 0.0)
        assert np.all(ps.state.zones.turb_lev.numpy() == 0.0)
        np.testing.assert_array_equal(ps.state.zones.tna.numpy(),
                                      np.asarray(js.state.zones.tna))
    assert len(seen_j) == len(seen_p) == 4
    peaks = []
    for (tlj, tnj), (tlp, tnp) in zip(seen_j, seen_p):
        np.testing.assert_allclose(tlp, tlj, rtol=1e-6, atol=1e-30)
        np.testing.assert_allclose(tnp, tnj, rtol=1e-6)
        peaks.append(tlp.max())
    # the boost peaks at the step nearest t_flare (t = 2 dt0) and in the
    # zone nearest (r, z) = (0.3, 0.5) 1e15 cm
    assert int(np.argmax(peaks)) == 2 and 0.5 < peaks[2] < 2.0
    assert np.unravel_index(np.argmax(seen_p[2][0]), (3, 2)) == (1, 0)


def test_adaptive_dt_rule_matches_reference(monkeypatch):
    """fp_step's dt_new replaced by 5 dt0 in the step at t = dt0 and by
    1e-9 dt0 after it: ncycle 0 keeps dt0, the next step takes 5 dt0,
    and the one after dt_min = min(dr_min, dz) L / c (dt0 / mcdt), the
    guard; equal to
    the reference's dt (rtol 1e-7) and the host mirror equal to the port's
    device dt."""
    js, ps = _pair(run=dict(adaptive_dt=True))
    dt0 = float(ps.state.dt)
    assert dt0 == float(js.state.dt)

    def j_wrap(fp, a, k):
        return fp(*a, **k)._replace(dt_new=jnp.where(
            a[7] < 1.5 * dt0, jnp.float32(5.0 * dt0),
            jnp.float32(1e-9 * dt0)))

    def p_wrap(fp, a, k):
        f = 5.0 if float(a[7]) < 1.5 * dt0 else 1e-9
        return fp(*a, **k)._replace(dt_new=torch.tensor(
            f * dt0, dtype=torch.float32))

    _patch(monkeypatch, j_wrap, p_wrap)
    dts = []
    for _ in range(3):
        js.step()
        ps.step()
        dt_p = float(ps.state.dt)
        np.testing.assert_allclose(dt_p, float(js.state.dt), rtol=1e-7)
        assert ps._host_dt == dt_p == js._host_dt
        dts.append(dt_p)
    g = ps.grid
    dt_min = min(float(torch.min(torch.diff(g.r_edges))), float(g.dz)) \
        * ps.scales.L / 2.99792458e10
    np.testing.assert_allclose(dts, [dt0, 5.0 * dt0, dt_min], rtol=1e-6)
    assert 1.0 < dt_min / dt0 < 5.0
    assert dt_min > 1e6 * 1e-9 * dt0       # the guard held
    np.testing.assert_allclose(ps._host_time, float(ps.state.time),
                               rtol=1e-6)


@pytest.fixture(scope="module")
def quiet_reference():
    """tests/test_runloop.py's quiet corona (optically thin, weak
    coupling: dT_max ~ 0, so the ladder triples dt) on the reference, run
    to t_stop = 10 dt0 under adaptive dt: its dt after each step, and the
    stopped simulation."""
    js, _ = _pair(run=dict(adaptive_dt=True), nz=2, n_e=1.0e2, seed=9)
    dt0 = float(js.state.dt)
    js.cfg = js.cfg.replace(run=dataclasses.replace(js.cfg.run,
                                                    t_stop=10.0 * dt0))
    dts = []
    for _ in range(3):
        js.step()
        dts.append(float(js.state.dt))
    assert js.run_to_stop()
    return dts, js


def _quiet_port(dt0_mult=10.0):
    ps = pex.small_corona(**{**TINY, "nz": 2, "n_e": 1.0e2, "seed": 9},
                          device="cpu")
    dt0 = float(ps.state.dt)
    return ps.with_config(ps.cfg.replace(run=dataclasses.replace(
        ps.cfg.run, adaptive_dt=True, t_stop=dt0_mult * dt0))), dt0


def test_adaptive_dt_grows_when_quiet(quiet_reference):
    """The port's dt sequence on the quiet corona equals the reference's
    (rtol 1e-6) and grows past 2 dt0 by the third step; its host mirror is
    the device's dt exactly."""
    dts_j, _ = quiet_reference
    ps, dt0 = _quiet_port()
    for dt_j in dts_j:
        ps.step()
        np.testing.assert_allclose(float(ps.state.dt), dt_j, rtol=1e-6)
    dt2 = float(ps.state.dt)
    assert dt2 > 2.0 * dt0, (dt0, dt2)
    assert ps._host_dt == dt2
    np.testing.assert_allclose(ps._host_time, float(ps.state.time),
                               rtol=1e-6)


def test_run_to_stop_under_adaptive_dt(quiet_reference, tmp_path):
    """run_to_stop stops on the read-back dt: time - dt_prev >= t_stop
    (xec2d.f:110) with a growing dt after as many steps as the
    reference's, at the same simulated time (rtol 1e-6), with the outputs
    written."""
    _, js = quiet_reference
    ps, dt0 = _quiet_port()
    ps.attach_outputs(str(tmp_path))
    assert ps.run_to_stop()
    n = int(ps.state.ncycle)
    assert n == int(js.state.ncycle)
    # constant dt would have taken 11 steps
    assert 3 <= n < 11
    t, dt_prev = float(ps.state.time), float(ps.state.dt_prev)
    np.testing.assert_allclose(t, float(js.state.time), rtol=1e-6)
    assert t - dt_prev >= 10.0 * dt0 * (1 - 1e-6)
    assert (tmp_path / "spectrum.dat").exists()
