"""Input decks in the reference's own format, written from Python.

:func:`write_deck` writes ``input.dat`` and the ``input_JJ_KK.dat`` zone
files in reader.f's field order (each line an 80-column label and the
value), which ``io.legacy.load_legacy_config`` reads. With no arguments it
writes the sample deck of the legacy importer's tests byte for byte.

Two decks drive the legacy path end to end (:func:`load_deck`):

``disk_deck``
    an accreting corona above a reflecting disk: ``small_corona``'s grid
    and zones (8x4 zones, z_max = r_max = 1e15 cm, Te 100 keV, n_e 1e10,
    B 10 G), a 0.5 keV blackbody disk on every lower ring, reflection off
    the lower boundary and the outer disk (cr_sent 3), the FP solve on, a
    coronal flare centred in the grid (peak at 2.5 dt0, widths dt0 and a
    quarter of the grid), and adaptive dt;
``ec_deck``
    an external-Compton blazar blob: ``blazar_jet``'s grid, zones and
    shock injection (10x5 zones, z_max 1e16, r_max 3e15 cm), every lower
    ring lit by a ``diskgen`` spectrum file at Gamma = 10 (BLR and torus
    boosted into the blob, tests/test_external_source.py's fields), in a
    window that opens at t0 = 2 dt0: the first two steps (mid-times 0.5
    and 1.5 dt0) run without the file, the third with it.

Widths are GridConfig's defaults, the reference's (general.pa): the legacy
loader reads no widths.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Optional

from compton2d_tpu_torch import constants as cn
from compton2d_tpu_torch.config import GridConfig
from compton2d_tpu_torch.grid import initial_dt, make_grid
from compton2d_tpu_torch.io import diskgen, legacy

# input.dat in reader.f's order, (label, field) around the windows,
# the photon regions and the light-curve bands
FIELDS_HEAD = (
    ("number of vertical zones", "nz"), ("number of radial zones", "nr"),
    ("z height [cm]", "z_max"), ("rmin [cm]", "r_min"),
    ("r max [cm]", "r_max"), ("star switch", "star_switch"),
    ("tstop [s]", "tstop"), ("mcdt", "mcdt"), ("ntime", "ntime"),
)
FIELDS_TAIL = (
    ("spectrum file", "spname"), ("photon file", "phname"),
    ("lc file", "lcname"), ("event file", "eventfile"),
    ("temperature file", "temp_file"), ("nst", "nst"), ("rseed", "rseed"),
    ("rand_switch", "rand_switch"), ("cr_sent", "cr_sent"),
    ("upper_sent", "upper_sent"), ("dh_sentinel", "dh_sentinel"),
    ("pair_switch", "pair_switch"), ("T_const", "T_const"),
    ("cf_sentinel", "cf_sentinel"),
) + tuple((k, k) for k in (
    "r_flare", "z_flare", "t_flare", "sigma_r", "sigma_z", "sigma_t",
    "flare_amp", "r_esc", "r_acc", "inj_switch", "inj_dis", "g2var_switch",
    "pick_sw", "inj_g1", "inj_g2", "inj_p", "inj_t", "inj_L", "pick_rate",
    "inj_gg", "inj_sigma", "g_bulk", "R_blr", "fr_blr", "R_ir", "fr_ir",
    "R_disk", "d_jet", "split1", "split2", "split3", "spl3_trg"))
SAMPLE = dict(
    nz=2, nr=2, z_max=1e15, r_min=0.0, r_max=2e15, star_switch=0,
    tstop=1e5, mcdt=0.3, spec_switch=0,
    regions=((1e-4, 1.0, 20), (1.0, 1e4, 30)), nmu=4,
    lc_bands=((2.0, 10.0),), spname="sp_test.dat", phname="ph_test.dat",
    lcname="lc_test_.dat", eventfile="evb.dat", temp_file="temp.dat",
    nst=5000, rseed=42, rand_switch=0, cr_sent=1, upper_sent=0,
    dh_sentinel=0, pair_switch=0, T_const=0, cf_sentinel=0, r_flare=0.0,
    z_flare=0.0, t_flare=0.0, sigma_r=1.0, sigma_z=1.0, sigma_t=1.0,
    flare_amp=0.0, r_esc=3.0, r_acc=1e9, inj_switch=1, inj_dis=2,
    g2var_switch=0, pick_sw=0, inj_g1=1e2, inj_g2=1e4, inj_p=2.4,
    inj_t=0.0, inj_L=1e42, pick_rate=0.0, inj_gg=1e3, inj_sigma=1e2,
    g_bulk=10.0, R_blr=1e17, fr_blr=0.1, R_ir=1e18, fr_ir=0.3,
    R_disk=1e15, d_jet=1e17, split1=1, split2=1, split3=1, spl3_trg=10,
)
ZONE_FIELDS = (
    ("tea [keV]", "tea"), ("tna [keV]", "tna"), ("n_e [cm^-3]", "n_e"),
    ("ep_switch", "ep_switch"), ("B [G]", "B_field"), ("amxwl", "amxwl"),
    ("gmin", "gmin"), ("gmax", "gmax"), ("p_nth", "p_nth"),
    ("q_turb", "q_turb"), ("turb_lev", "turb_lev"),
)
SAMPLE_ZONE = dict(tea=100.0, tna=100.0, n_e=1e10, ep_switch=0,
                   B_field=10.0, amxwl=0.9, gmin=1e2, gmax=1e5, p_nth=2.5,
                   q_turb=1.6666667, turb_lev=0.0)


def _value(v) -> str:
    """Integers and names as they are, floats as the sample's 1.0000000e15."""
    if isinstance(v, (int, str)):
        return str(v)
    mant, exp = f"{v:.7e}".split("e")
    e = int(exp)
    return f"{mant}e{'-' if e < 0 else ''}{abs(e):02d}"


def _fmt(label, value) -> str:
    return label.ljust(80) + _value(value) + "\n"


def window(nr: int, t0: float = 0.0, t1: float = 1e30, tbbu=0.0,
           tbbl=0.5, ufile: str = "none", lfile: str = "none") -> dict:
    """One time window: the same temperatures and file names on every
    ring."""
    return dict(t0=t0, t1=t1, tbbu=(tbbu,) * nr, tbbl=(tbbl,) * nr,
                ufile=(ufile,) * nr, lfile=(lfile,) * nr)


def write_deck(dirpath: str, windows=None, zone: Optional[dict] = None,
               **fields) -> None:
    """Write input.dat and the nz*nr zone files into ``dirpath``: the
    sample deck with ``fields`` changed, ``windows`` (default: one window
    with a 0.5 keV lower boundary) and the same ``zone`` values in every
    zone."""
    d = {**SAMPLE, **fields}
    nz, nr = d["nz"], d["nr"]
    windows = windows or [window(nr)]
    d["ntime"] = len(windows)
    lines = [_fmt(label, d[k]) for label, k in FIELDS_HEAD]
    a = lines.append
    for w in windows:
        a(_fmt("t0", float(w["t0"])))
        a(_fmt("t1", float(w["t1"])))
        for k in range(nr):
            a(_fmt(f"tbbu({k+1})", float(w["tbbu"][k])))
            a(_fmt("ufile", w["ufile"][k]))
            a(_fmt(f"tbbl({k+1})", float(w["tbbl"][k])))
            a(_fmt("lfile", w["lfile"][k]))
    a(_fmt("spec_switch", d["spec_switch"]))
    a(_fmt("number of photon regions", len(d["regions"])))
    for q, (lo, hi, nb) in enumerate(d["regions"]):
        a(_fmt(f"Ephmin({q+1})", float(lo)))
        a(_fmt(f"Ephmax({q+1})", float(hi)))
        a(_fmt(f"nphbins({q+1})", int(nb)))
    a(_fmt("nmu", d["nmu"]))
    a(_fmt("nph_lc", len(d["lc_bands"])))
    for q, (lo, hi) in enumerate(d["lc_bands"]):
        a(_fmt(f"Elcmin({q+1})", float(lo)))
        a(_fmt(f"Elcmax({q+1})", float(hi)))
    lines += [_fmt(label, d[k]) for label, k in FIELDS_TAIL]
    with open(os.path.join(dirpath, "input.dat"), "w") as fh:
        fh.writelines(lines)
    z = {**SAMPLE_ZONE, **(zone or {})}
    zl = [_fmt(label, z[k]) for label, k in ZONE_FIELDS]
    for j in range(nz):
        for k in range(nr):
            with open(os.path.join(dirpath, f"input_{j+1:02d}_{k+1:02d}.dat"),
                      "w") as fh:
                fh.writelines(zl)


def _dt0(nz, nr, z_max, r_max, mcdt, g_bulk) -> float:
    """The first step's dt as the Simulation will compute it."""
    g = GridConfig(nz=nz, nr=nr, z_max=z_max, r_max=r_max)
    v = (cn.C_LIGHT * max(1.0 - 1.0 / g_bulk ** 2, 1e-12) ** 0.5
         if g_bulk > 1.0 else cn.C_LIGHT)
    L = max(z_max, r_max)
    return initial_dt(make_grid(g, L), mcdt, v, length_scale=L)


def write_disk_deck(dirpath: str, nz: int = 8, nr: int = 4,
                    nst: int = 60000, seed: int = 0,
                    mcdt: float = SAMPLE["mcdt"]) -> float:
    """The disk deck (module docstring); returns its dt0 [s]. ``mcdt``
    sets dt0 in units of the light-crossing time of the thinnest zone,
    which is also adaptive dt's floor dt_min: at the sample's 0.3 the FP
    ladder's dt lies below the floor, above 1 it starts above it."""
    z_max = r_max = 1e15
    dt0 = _dt0(nz, nr, z_max, r_max, mcdt, 1.0)
    write_deck(
        dirpath, nz=nz, nr=nr, z_max=z_max, r_max=r_max, nst=nst, mcdt=mcdt,
        rseed=seed, regions=((1e-4, 1e-1, 20), (1e-1, 1e4, 40)), nmu=4,
        lc_bands=((2.0, 10.0),), cr_sent=3, spec_switch=0, T_const=0,
        inj_switch=0, g_bulk=1.0, cf_sentinel=1, r_flare=0.5 * r_max,
        z_flare=0.5 * z_max, t_flare=2.5 * dt0, sigma_t=dt0,
        sigma_r=0.25 * r_max, sigma_z=0.25 * z_max, flare_amp=1.0,
        windows=[window(nr, tbbl=0.5)],
        zone=dict(tea=100.0, tna=100.0, n_e=1e10, B_field=10.0, amxwl=1.0,
                  gmin=1e3, gmax=1e5, p_nth=2.5, q_turb=1.6667,
                  turb_lev=0.0))
    return dt0


def write_ec_deck(dirpath: str, nz: int = 10, nr: int = 5,
                  nst: int = 60000, seed: int = 0) -> float:
    """The external-Compton deck (module docstring), with its diskgen
    spectrum file ``blackbody.in`` beside input.dat; returns its dt0."""
    z_max, r_max, g_bulk = 1e16, 3e15, 10.0
    dt0 = _dt0(nz, nr, z_max, r_max, SAMPLE["mcdt"], g_bulk)
    diskgen.write_spectrum_file(os.path.join(dirpath, "blackbody.in"),
                                gamma_bulk=g_bulk)
    write_deck(
        dirpath, nz=nz, nr=nr, z_max=z_max, r_max=r_max, nst=nst,
        rseed=seed, regions=((1e-7, 1e-2, 30), (1e-2, 1e3, 40),
                             (1e3, 1e7, 30)), nmu=8,
        lc_bands=((2.0, 10.0), (1e5, 1e7)), cr_sent=0, T_const=0,
        inj_switch=1, inj_dis=2, inj_g1=1e2, inj_g2=1e4, inj_p=2.4,
        inj_L=1e42, inj_t=0.0, r_acc=1e3, r_esc=3.0, g_bulk=g_bulk,
        R_blr=1e17, fr_blr=0.1, R_ir=1e18, fr_ir=0.3, R_disk=1e15,
        d_jet=1e17,
        windows=[window(nr, t0=2.0 * dt0, tbbl=-1.0, lfile="blackbody.in")],
        zone=dict(tea=10.0, tna=10.0, n_e=1e4, B_field=1.0, amxwl=0.1,
                  gmin=1e2, gmax=1e4, p_nth=2.4, q_turb=1.6667,
                  turb_lev=0.0))
    return dt0


WRITERS = {"disk_deck": write_disk_deck, "ec_deck": write_ec_deck}


def load_deck(name: str, dirpath: str, grid: Optional[dict] = None,
              nz: Optional[int] = None, nr: Optional[int] = None,
              nst: Optional[int] = None, seed: int = 0,
              mcdt: Optional[float] = None,
              **run_overrides) -> legacy.LegacyConfig:
    """Write the deck ``name`` into ``dirpath`` and load it with the
    legacy importer; ``grid`` changes GridConfig fields after the load
    (narrower widths for tests), ``run_overrides`` go to the loader
    (n_slots, max_flight_iters, event_capacity, ...). The disk deck runs
    with adaptive dt (``mcdt``: its dt0, write_disk_deck)."""
    shape = {k: v for k, v in dict(nz=nz, nr=nr, nst=nst,
                                   mcdt=mcdt).items() if v is not None}
    WRITERS[name](dirpath, seed=seed, **shape)
    if name == "disk_deck":
        run_overrides.setdefault("adaptive_dt", True)
    lc = legacy.load_legacy_config(dirpath, **run_overrides)
    if grid:
        g = dataclasses.replace(lc.cfg.grid, **grid)
        lc = dataclasses.replace(lc, cfg=lc.cfg.replace(grid=g))
    return lc


def deck_sim(name: str, device="cuda", seed: int = 0, **shape):
    """A Simulation of the deck ``name`` at full width: 131072 slots, 256
    flight iterations and an event record per slot, on ``device``; the
    deck is written to a temporary directory that is gone once the
    Simulation has read it (``shape``: nz, nr, nst, grid, mcdt)."""
    from compton2d_tpu_torch.driver import Simulation

    with tempfile.TemporaryDirectory() as d:
        lc = load_deck(name, d, seed=seed, n_slots=1 << 17,
                       max_flight_iters=256, event_capacity=1 << 17,
                       **shape)
        return Simulation(lc.cfg, lc.zones, device=device)
