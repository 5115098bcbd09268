"""The port's legacy importer and disk-spectrum generator against the JAX
package's: the same written deck through both loaders, ``diskgen`` and
``external_spectrum`` bit for bit, the copies' source text, the port's
deck writer against the importer tests' sample writer, and the importer
tests' cases run on the port."""
import dataclasses
import filecmp
import inspect
import os

import numpy as np
import pytest
import torch

from compton2d_tpu import config as jcfg
from compton2d_tpu.io import diskgen as jdisk
from compton2d_tpu.io import legacy as jleg
from compton2d_tpu_torch import config as pcfg
from compton2d_tpu_torch import decks
from compton2d_tpu_torch.driver import Simulation
from compton2d_tpu_torch.io import diskgen as pdisk
from compton2d_tpu_torch.io import legacy as pleg
from test_legacy import _write_sample

torch.set_num_threads(2)


def _assert_zones_equal(zp, zj):
    for f in dataclasses.fields(zj):
        a, b = getattr(zp, f.name), getattr(zj, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


def test_copied_modules_are_the_reference_source():
    """Every function and class of the copies is the reference's source
    text (only the imports and the module docstrings differ)."""
    for ref, port in ((jleg, pleg), (jdisk, pdisk)):
        names = [n for n, v in vars(ref).items()
                 if (inspect.isfunction(v) or inspect.isclass(v))
                 and v.__module__ == ref.__name__]
        assert names
        for name in names:
            assert inspect.getsource(getattr(port, name)) == \
                inspect.getsource(getattr(ref, name)), name


def test_deck_writer_writes_the_sample_deck(tmp_path):
    """decks.write_deck with no changes writes, byte for byte, the sample
    deck of tests/test_legacy.py."""
    a, b = tmp_path / "port", tmp_path / "reference"
    a.mkdir()
    b.mkdir()
    decks.write_deck(str(a))
    _write_sample(str(b))
    names = sorted(os.listdir(b))
    assert names == sorted(os.listdir(a)) and len(names) == 5
    for nm in names:
        assert filecmp.cmp(a / nm, b / nm, shallow=False), nm


@pytest.mark.parametrize("deck", ["sample", "disk_deck", "ec_deck"])
def test_both_loaders_give_equal_configs(tmp_path, deck):
    """The same deck through both importers: SimConfig equal field by field
    (the port's config has every field the loader sets), ZoneInit arrays
    equal, and the other records of LegacyConfig equal."""
    if deck == "sample":
        decks.write_deck(str(tmp_path))
    else:
        decks.WRITERS[deck](str(tmp_path), nz=3, nr=2, nst=700, seed=3)
    over = dict(n_slots=2048, event_capacity=2048, adaptive_dt=True)
    lj = jleg.load_legacy_config(str(tmp_path), **over)
    lp = pleg.load_legacy_config(str(tmp_path), **over)
    assert dataclasses.asdict(lp.cfg) == dataclasses.asdict(lj.cfg)
    assert type(lp.cfg.physics.flare) is pcfg.FlareConfig
    assert type(lp.cfg.source.external) is pcfg.ExternalRadiationConfig
    assert type(lp.cfg.windows[0]) is pcfg.TimeWindow
    _assert_zones_equal(lp.zones, lj.zones)
    for name in ("filenames", "spectrum_files", "seed", "splits"):
        assert getattr(lp, name) == getattr(lj, name), name
    if deck == "ec_deck":
        assert lp.cfg.windows[0].lower_spectra[0].endswith("blackbody.in")
        assert all(t < 0 for t in lp.cfg.windows[0].tbb_lower)
    if deck == "disk_deck":
        assert lp.cfg.physics.cr_sent == 3 and lp.cfg.physics.flare.enabled


@pytest.mark.parametrize("kw", [dict(gamma_bulk=10.0),
                                dict(gamma_bulk=5.0, n_bins=200,
                                     pl_tail=False),
                                dict(gamma_bulk=20.0, e0_kev=1e-6)])
def test_diskgen_bitwise(tmp_path, kw):
    """generate and the written file are bit for bit the reference's, with
    and without a Tavecchio table."""
    np.testing.assert_array_equal(pdisk.generate(**kw), jdisk.generate(**kw))
    tave = np.stack([np.geomspace(1e-6, 1e-1, 40),
                     np.geomspace(1e-3, 1e-5, 40)], axis=1)
    np.testing.assert_array_equal(
        pdisk.generate(**kw, tavecchio_table=tave),
        jdisk.generate(**kw, tavecchio_table=tave))
    g = kw["gamma_bulk"]
    pdisk.write_spectrum_file(str(tmp_path / "p.in"), gamma_bulk=g)
    jdisk.write_spectrum_file(str(tmp_path / "j.in"), gamma_bulk=g)
    assert filecmp.cmp(tmp_path / "p.in", tmp_path / "j.in", shallow=False)


@pytest.mark.parametrize("g_bulk", [10.0, 3.0])
def test_external_spectrum_equal(tmp_path, g_bulk):
    """external_spectrum on a diskgen file: energies, fluxes, CDF and the
    integrated flux equal (the same numpy on the same file)."""
    path = str(tmp_path / "bb.in")
    jdisk.write_spectrum_file(path, gamma_bulk=10.0)
    kw = dict(R_blr=1e17, fr_blr=0.1, R_ir=1e18, fr_ir=0.3, R_disk=1e15,
              d_jet=1e17, g_bulk=g_bulk)
    rp = pleg.external_spectrum(path, pcfg.ExternalRadiationConfig(**kw))
    rj = jleg.external_spectrum(path, jcfg.ExternalRadiationConfig(**kw))
    for a, b in zip(rp[:3], rj[:3]):
        np.testing.assert_array_equal(a, b)
    assert rp[3] == rj[3] > 0.0
    assert rp[2][0] == 0.0 and np.isclose(rp[2][-1], 1.0)


# ---- tests/test_legacy.py's cases, on the port -----------------------------
def test_legacy_roundtrip(tmp_path):
    _write_sample(str(tmp_path))
    lc = pleg.load_legacy_config(str(tmp_path))
    cfg = lc.cfg
    assert cfg.grid.nz == 2 and cfg.grid.nr == 2
    assert np.isclose(cfg.grid.z_max, 1e15)
    assert np.isclose(cfg.grid.r_max, 2e15)
    assert cfg.grid.nphtotal == 50
    assert cfg.grid.nmu == 4
    assert cfg.physics.cr_sent == 1
    assert not cfg.physics.t_const
    assert cfg.physics.injection.switch == 1
    assert np.isclose(cfg.physics.injection.luminosity, 1e42)
    assert cfg.source.nst == 5000
    assert lc.seed == 42
    assert np.isclose(cfg.windows[0].tbb_lower[0], 0.5)
    assert np.isclose(lc.zones.tea[0, 0], 100.0)
    assert np.isclose(lc.zones.amxwl[1, 1], 0.9)
    # the imported config (lower-boundary reflection) runs a CPU step
    cfg2 = cfg.replace(
        grid=dataclasses.replace(cfg.grid, num_nt=40, n_vol=32, nphfield=32,
                                 n_gg=16, n_ref=50),
        run=cfg.run.__class__(seed=lc.seed, n_slots=1024,
                              event_capacity=1024))
    sim = Simulation(cfg2, lc.zones, device="cpu")
    out = sim.step()
    assert np.isfinite(float(out.bingo))


def test_malformed_input_names_the_field(tmp_path):
    _write_sample(str(tmp_path))
    path = os.path.join(str(tmp_path), "input.dat")
    with open(path) as fh:
        lines = fh.readlines()
    lines[2] = "z height [cm]".ljust(80) + "bogus\n"
    with open(path, "w") as fh:
        fh.writelines(lines)
    with pytest.raises(pleg.LegacyConfigError, match="z_max"):
        pleg.parse_input_dat(path)


def test_truncated_input_names_the_field(tmp_path):
    _write_sample(str(tmp_path))
    path = os.path.join(str(tmp_path), "input.dat")
    with open(path) as fh:
        lines = fh.readlines()
    with open(path, "w") as fh:
        fh.writelines(lines[:-4])
    with pytest.raises(pleg.LegacyConfigError, match="split|spl3"):
        pleg.parse_input_dat(path)


def test_invalid_ranges_are_collected(tmp_path):
    _write_sample(str(tmp_path))
    path = os.path.join(str(tmp_path), "input.dat")
    with open(path) as fh:
        lines = fh.readlines()
    lines[3] = "rmin [cm]".ljust(80) + "3.0000000e15\n"
    lines[10] = "t1".ljust(80) + "-1.0000000e00\n"
    with open(path, "w") as fh:
        fh.writelines(lines)
    with pytest.raises(pleg.LegacyConfigError) as ei:
        pleg.parse_input_dat(path)
    msg = str(ei.value)
    assert "r_max" in msg and "window[0]" in msg


def test_missing_zone_file_named(tmp_path):
    _write_sample(str(tmp_path))
    os.remove(os.path.join(str(tmp_path), "input_02_01.dat"))
    with pytest.raises(pleg.LegacyConfigError, match="input_02_01"):
        pleg.load_legacy_config(str(tmp_path))


def test_config_echo_written(tmp_path):
    """The port's echo is the reference's, line for line."""
    _write_sample(str(tmp_path))
    echo_p, echo_j = str(tmp_path / "log_p.txt"), str(tmp_path / "log_j.txt")
    pleg.load_legacy_config(str(tmp_path), echo_path=echo_p)
    jleg.load_legacy_config(str(tmp_path), echo_path=echo_j)
    text = open(echo_p).read()
    for frag in ("nz = 2", "tstop = 100000", "window[0]", "split1 = 1",
                 "g_bulk = 10", "nst = 5000"):
        assert frag in text, frag
    assert text == open(echo_j).read()
