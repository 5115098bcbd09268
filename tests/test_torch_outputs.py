"""The port's run-level outputs: its copies of the JAX package's numpy
``io`` modules give bitwise-equal arrays and byte-equal files on the same
events and tallies; ``run_to_stop`` with outputs attached writes the
reference's files in the reference's format; and the reference's small
Mrk 421 workload test, run on the port."""
import dataclasses
import os
import re
from collections import namedtuple

import numpy as np
import torch

from compton2d_tpu import examples as jex
from compton2d_tpu.io import checkpoint as jckpt
from compton2d_tpu.io import events as jev
from compton2d_tpu.io import outputs as jout
from compton2d_tpu.io import postprocess as jpp
from compton2d_tpu_torch import examples as pex
from compton2d_tpu_torch import run_mrk421
from compton2d_tpu_torch.io import checkpoint as pckpt
from compton2d_tpu_torch.io import events as pev
from compton2d_tpu_torch.io import outputs as pout
from compton2d_tpu_torch.io import postprocess as ppp
from compton2d_tpu_torch.state import EventBuffer

torch.set_num_threads(2)

Buf = namedtuple("Buf", "data count")
Tal = namedtuple("Tal", "fout edout")


def _events(seed, cap=300, ndev=1):
    rng = np.random.default_rng(seed)
    data = np.stack([
        rng.uniform(0, 7e4, ndev * cap),
        10.0 ** rng.uniform(-6, 8, ndev * cap),
        rng.gamma(0.5, 1.0, ndev * cap), rng.uniform(0, 1, ndev * cap),
        rng.uniform(0, 1, ndev * cap), rng.uniform(-1, 1, ndev * cap),
        rng.uniform(-np.pi, np.pi, ndev * cap)], axis=1).astype(np.float32)
    count = rng.integers(cap // 2, cap, ndev).astype(np.int32)
    count[-1] += cap // 2 + 17   # the last buffer overflowed
    return data, count


def _bufs(data, count):
    return (Buf(data, count),
            EventBuffer(data=torch.as_tensor(data),
                        count=torch.as_tensor(count)))


def test_event_sinks_equal_reference(tmp_path):
    """buffer_to_numpy (one and two stacked device buffers, counts past
    the capacity), EventArrayStore and EventFileWriter against the
    reference's: arrays bitwise, files byte for byte, dropped counts."""
    scale = 3.7e44
    jw = jev.EventFileWriter(str(tmp_path / "j" / "evb.dat"), scale)
    pw = pev.EventFileWriter(str(tmp_path / "p" / "evb.dat"), scale)
    js, ps = jev.EventArrayStore(scale), pev.EventArrayStore(scale)
    for seed, ndev in ((0, 1), (1, 2), (2, 1)):
        jb, pb = _bufs(*_events(seed, ndev=ndev))
        np.testing.assert_array_equal(pev.buffer_to_numpy(pb, scale),
                                      jev.buffer_to_numpy(jb, scale))
        assert pw.write(pb) == jw.write(jb)
        assert ps.write(pb) == js.write(jb)
    jw.close()
    np.testing.assert_array_equal(ps.all(), js.all())
    assert (ps.n_dropped, pw.n_dropped, pw.n_written) == (
        js.n_dropped, jw.n_dropped, jw.n_written)
    assert pw.n_dropped > 0
    jb_, pb_ = (open(tmp_path / d / "evb.dat", "rb").read() for d in "jp")
    assert pb_ == jb_ and len(pb_) > 0
    np.testing.assert_array_equal(
        pev.read_event_file(str(tmp_path / "p" / "evb.dat")),
        jev.read_event_file(str(tmp_path / "j" / "evb.dat")))


def test_output_accumulator_files_equal_reference(tmp_path):
    """Three steps of tallies (host tensors on the port's side, numpy on
    the reference's) make byte-equal spectrum, photon spectrum, light
    curve and temperature profile files."""
    rng = np.random.default_rng(3)
    hu = np.geomspace(1e-8, 1e8, 61)
    mu_edges = np.linspace(-0.8, 1.0, 10)
    bands = ((1e-3, 3e-3), (2.0, 4.0), (1e9, 1e10))
    acc = {"j": jout.OutputAccumulator(hu, mu_edges, bands, 2.5e43),
           "p": pout.OutputAccumulator(hu, mu_edges, bands, 2.5e43)}
    for k in range(3):
        fout = rng.gamma(0.3, 1.0, (10, 60)).astype(np.float32)
        edout = rng.gamma(0.3, 1.0, (10, 3)).astype(np.float32)
        tea = rng.uniform(1.0, 1e3, (4, 2)).astype(np.float32)
        acc["j"].add_step(Tal(fout, edout), 5e3 * k, 5e3, tea=tea)
        acc["p"].add_step(Tal(torch.as_tensor(fout), torch.as_tensor(edout)),
                          5e3 * k, 5e3, tea=torch.as_tensor(tea).numpy())
    r_edges = np.linspace(0.0, 2.5e15, 3)
    n_e = rng.uniform(1.0, 10.0, (4, 2))
    for side, a in acc.items():
        d = str(tmp_path / side)
        a.write_spectrum(os.path.join(d, "spectrum.dat"), 1.5e4)
        a.write_spectrum(os.path.join(d, "photons.dat"), 1.5e4,
                         photons=True)
        a.write_light_curves(os.path.join(d, "lc"))
        a.write_temperature_profile(os.path.join(d, "temp_profile.dat"),
                                    r_edges, n_e=n_e)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "p")) and len(names) == 13
    for name in names:
        assert (open(tmp_path / "p" / name, "rb").read()
                == open(tmp_path / "j" / name, "rb").read()), name


def test_postprocess_equal_reference():
    """Doppler transform, light curves and SED of the same events, with
    the Mrk 421 constants: bitwise equal."""
    data, count = _events(4, cap=5000)
    ev = data.astype(np.float64)
    ev[:, 2] *= 1e44
    np.testing.assert_array_equal(ppp.doppler_transform(ev, 33.0, 2.5e15),
                                  jpp.doppler_transform(ev, 33.0, 2.5e15))
    t_edges = np.arange(0.0, 8 * pex.MRK421_DT_S, pex.MRK421_DT_S)
    lp = ppp.light_curves(ev, pex.MRK421_GAMMA, 2.5e15, t_edges,
                          np.asarray(pex.MRK421_BANDS))
    lj = jpp.light_curves(ev, jex.MRK421_GAMMA, 2.5e15, t_edges,
                          np.asarray(jex.MRK421_BANDS))
    for f in ("flux", "flux_sq", "counts"):
        np.testing.assert_array_equal(getattr(lp, f), getattr(lj, f))
    np.testing.assert_array_equal(lp.rate(), lj.rate())
    e_edges = np.geomspace(1e-8, 1e11, 150)
    sp = ppp.sed(ev, 33.0, 2.5e15, 0.0, 1e5, e_edges,
                 mu_range=pex.MRK421_MU_RANGE)
    sj = jpp.sed(ev, 33.0, 2.5e15, 0.0, 1e5, e_edges,
                 mu_range=jex.MRK421_MU_RANGE)
    np.testing.assert_array_equal(sp.nu_f_nu(), sj.nu_f_nu())
    np.testing.assert_array_equal(sp.counts, sj.counts)


def test_walltime_guard_matches_reference():
    for budget in (0.0, 1e6, 1e-9):
        assert (pckpt.WalltimeGuard(budget).should_checkpoint()
                == jckpt.WalltimeGuard(budget).should_checkpoint())


_ROW = re.compile(r"^( [ -]\d\.\d{7}e[+-]\d{2})+$")
SMALL = dict(nz=4, nr=2, nst=1500, n_slots=8192, num_nt=160, n_vol=64,
             nphfield=64)


def _three_step(sim):
    """The config with t_stop between the second and third step's end:
    run_to_stop takes exactly three steps."""
    dt = float(sim.state.dt)
    return dataclasses.replace(sim.cfg, run=dataclasses.replace(
        sim.cfg.run, t_stop=1.5 * dt))


def test_run_to_stop_writes_reference_outputs(tmp_path):
    """run_to_stop on a small Mrk 421 (splitting on) takes three steps and
    writes spectrum.dat, photons.dat, the ten lc_muNN.dat, temp_profile.dat
    and evb.dat with the reference's rows and columns in e14.7, like the
    reference's run of the same configuration; the run_mrk421
    post-processing writes its SED and light curves from the events."""
    jsim = jex.mrk421(**SMALL)
    jsim = jsim.with_config(_three_step(jsim))
    jsim.attach_outputs(str(tmp_path / "j"))
    assert jsim.run_to_stop()
    psim = pex.mrk421(**SMALL, device="cpu")
    cfg = _three_step(psim)
    psim = psim.with_config(dataclasses.replace(
        cfg, source=dataclasses.replace(cfg.source, strat_split=True,
                                        strat_copies=4)))
    psim.attach_outputs(str(tmp_path / "p"))
    assert psim.run_to_stop()
    assert int(psim.state.ncycle) == int(jsim.state.ncycle) == 3
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "p")) == names
    assert len([n for n in names if n.startswith("lc_mu")]) == 10
    for name in names:
        pl = open(tmp_path / "p" / name).read().splitlines()
        jl = open(tmp_path / "j" / name).read().splitlines()
        if name != "evb.dat":
            assert len(pl) == len(jl), name
        assert pl and all(_ROW.match(" " + ln) for ln in pl), name
        assert {len(ln.split()) for ln in pl} == {len(ln.split())
                                                  for ln in jl}, name
    events = pev.read_event_file(str(tmp_path / "p" / "evb.dat"))
    assert events.shape[0] == psim.event_writer.n_written > 0
    assert psim.outputs.n_steps == 3
    peaks = run_mrk421.postprocess(events, psim.cfg.grid.r_max,
                                   str(tmp_path / "p"))
    assert peaks["sync_peak_keV_obs"] is not None
    sed = np.loadtxt(tmp_path / "p" / "sed.dat")
    lc = np.loadtxt(tmp_path / "p" / "lc.dat")
    assert sed.shape[1] == 4 and lc.shape[1] == 1 + len(pex.MRK421_BANDS)


def test_mrk421_small_run():
    """tests/test_mrk421.py::test_mrk421_small_run on the port: four steps
    with the audit within 5e-3, escaping events, finite Doppler light
    curves and a positive SED."""
    sim = pex.mrk421(**SMALL, device="cpu")
    store = pev.EventArrayStore(sim.scales.E)
    for _ in range(4):
        out = sim.step()
        store.write(out.events)
        a = sim.energy_audit()
        assert np.isclose(a["balance"], 1.0, atol=5e-3), a
    evts = store.all()
    assert evts.shape[0] > 0
    lc = ppp.light_curves(
        evts, pex.MRK421_GAMMA, sim.cfg.grid.r_max,
        t_edges=np.arange(0.0, 8 * pex.MRK421_DT_S, pex.MRK421_DT_S),
        e_bands=np.asarray(pex.MRK421_BANDS),
        mu_edges=np.array([pex.MRK421_MU_RANGE[0],
                           pex.MRK421_MU_RANGE[1]]),
    )
    assert np.all(np.isfinite(lc.flux))
    sed = ppp.sed(evts, pex.MRK421_GAMMA, sim.cfg.grid.r_max, 0.0, 1e9,
                  np.geomspace(1e-8, 1e10, 60))
    assert sed.flux.sum() > 0


def test_run_mrk421_writes_the_reference_summary(tmp_path, monkeypatch):
    """python -m compton2d_tpu_torch.run_mrk421 on a small grid (the
    configuration narrowed through the constructor it calls): it runs to
    t_stop and writes sed.dat, lc.dat and a summary.json with exactly the
    keys of the reference's committed summary.json."""
    import json

    monkeypatch.setattr(run_mrk421, "mrk421", lambda **kw: pex.mrk421(
        nz=4, nr=2, num_nt=160, n_vol=64, nphfield=64, **kw))
    out = str(tmp_path / "mrk")
    run_mrk421.main(["--nst", "1500", "--n-slots", "8192", "--t-stop",
                     "1e4", "--strat-copies", "4", "--device", "cpu",
                     "--out", out])
    with open(os.path.join(out, "summary.json")) as fh:
        summary = json.load(fh)
    ref_path = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                            "mrk421_dense", "summary.json")
    with open(ref_path) as fh:
        ref = json.load(fh)
    assert set(summary) == set(ref)
    assert summary["backend"] == "cpu" and summary["steps"] == 2
    assert abs(summary["balance"] - 1.0) < 5e-3
    for name in ("sed.dat", "lc.dat", "evb.dat", "spectrum.dat"):
        assert os.path.getsize(os.path.join(out, name)) > 0, name
