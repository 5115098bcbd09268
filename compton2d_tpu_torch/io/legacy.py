"""A copy of the reference's jax-free ``compton2d_tpu.io.legacy``, so
that the port imports nothing of the JAX package. Keep the two in step.

Legacy configuration importer.

Reads the reference's fixed-format inputs so a user of the Fortran code
can run the same setup here:

- ``input/input.dat`` — global config, exact field order of
  ``reference/src/reader.f:157-597`` (each line: an 80-column
  label field followed by the value; we also accept the value as the
  last whitespace token for hand-written files);
- ``input/input_JJ_KK.dat`` — 11 per-zone fields (reader.f:608-657);
- 4-column external spectrum files (E, L_disk, F_blr, F_ir) with the
  Ghisellini-Tavecchio/Ghisellini-Madau boosted BLR+torus construction
  of ``file_sp`` (imcsurf2d_para.f:544-685).
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from compton2d_tpu_torch import constants as cn
from compton2d_tpu_torch.config import (
    FlareConfig,
    GridConfig,
    InjectionConfig,
    PhysicsConfig,
    RunConfig,
    SimConfig,
    SourceConfig,
    ExternalRadiationConfig,
    TimeWindow,
    ZoneInit,
)


class LegacyConfigError(ValueError):
    """Malformed or inconsistent legacy input, with field context.

    The reference validates inputs and reports to ``errors.txt``
    (reader.f:153,170-201,599-601); here a parse or range failure names
    the field and the input line instead of surfacing as a bare
    ``float()`` traceback or a silently shifted field (the format is
    order-dependent)."""


class _Lines:
    """Sequential fixed-format reader: value at column 81+, with a
    whitespace-token fallback. Each read names its field so format
    errors point at the offending line."""

    def __init__(self, path: str):
        self.path = path
        with open(path) as fh:
            self.lines = fh.readlines()
        self.i = 0

    def _next(self, field: str) -> str:
        if self.i >= len(self.lines):
            raise LegacyConfigError(
                f"{self.path}: unexpected end of file while reading "
                f"field '{field}' (line {self.i + 1}); the fixed format "
                f"is order-dependent — check for missing lines above"
            )
        line = self.lines[self.i]
        self.i += 1
        return line.rstrip("\n")

    def _value(self, line: str) -> str:
        if len(line) > 80 and line[80:].strip():
            return line[80:].strip()
        parts = line.split()
        return parts[-1] if parts else ""

    def f(self, field: str = "?") -> float:
        lineno = self.i + 1
        raw = self._value(self._next(field))
        try:
            return float(raw.replace("d", "e").replace("D", "E"))
        except ValueError:
            raise LegacyConfigError(
                f"{self.path}:{lineno}: field '{field}' expected a "
                f"real number, got {raw!r}"
            ) from None

    def i_(self, field: str = "?") -> int:
        lineno = self.i + 1
        raw = self._value(self._next(field))
        try:
            return int(float(raw.replace("d", "e").replace("D", "E")))
        except ValueError:
            raise LegacyConfigError(
                f"{self.path}:{lineno}: field '{field}' expected an "
                f"integer, got {raw!r}"
            ) from None

    def s(self, field: str = "?") -> str:
        return self._value(self._next(field))


@dataclass
class LegacyConfig:
    cfg: SimConfig
    zones: ZoneInit
    filenames: dict
    spectrum_files: dict      # boundary side -> filename (if any)
    seed: int
    splits: Tuple[int, int, int, int]


def parse_input_dat(path: str) -> dict:
    """Parse input/input.dat in reader.f order; raises
    LegacyConfigError with field context on malformed lines."""
    L = _Lines(path)
    d = {}
    d["nz"] = L.i_("nz")
    d["nr"] = L.i_("nr")
    d["z_max"] = L.f("z_max")
    d["r_min"] = L.f("r_min")
    d["r_max"] = L.f("r_max")
    d["star_switch"] = L.i_("star_switch")
    if d["star_switch"] == 1:
        d["r_star"] = L.f("r_star")
        d["dist_star"] = L.f("dist_star")
    else:
        d["r_star"] = 1.0
        d["dist_star"] = 1.0
    d["tstop"] = L.f("tstop")
    d["mcdt"] = L.f("mcdt")
    d["ntime"] = L.i_("ntime")
    if not (1 <= d["ntime"] <= 10_000):
        raise LegacyConfigError(
            f"{path}: ntime={d['ntime']} out of range [1, 10000] "
            f"(reference cap ntmax=100, general.pa:11)"
        )
    if d["nz"] < 1 or d["nr"] < 1:
        raise LegacyConfigError(
            f"{path}: grid sizes nz={d['nz']}, nr={d['nr']} must be "
            f">= 1 (reference caps jmax=kmax=99, general.pa:10-12)"
        )

    windows = []
    for t in range(d["ntime"]):
        t0 = L.f(f"window[{t}].t0")
        t1 = L.f(f"window[{t}].t1")
        tbbu, tbbl, ufn, lfn = [], [], [], []
        for _k in range(d["nr"]):
            tbbu.append(L.f(f"window[{t}].tbb_upper[{_k}]"))
            ufn.append(L.s(f"window[{t}].upper_spectrum[{_k}]"))
            tbbl.append(L.f(f"window[{t}].tbb_lower[{_k}]"))
            lfn.append(L.s(f"window[{t}].lower_spectrum[{_k}]"))
        # tbbi/tbbo are forced to 0 in the active reference
        # (reader.f:400-405)
        windows.append(
            dict(t0=t0, t1=t1, tbbu=tbbu, tbbl=tbbl, ufn=ufn, lfn=lfn)
        )
    d["windows"] = windows

    d["spec_switch"] = L.i_("spec_switch")
    d["nphreg"] = L.i_("nphreg")
    regions = []
    for q in range(d["nphreg"]):
        emin = L.f(f"region[{q}].E_min")
        emax = L.f(f"region[{q}].E_max")
        nb = L.i_(f"region[{q}].nbins")
        regions.append((emin, emax, nb))
    d["regions"] = regions
    d["nmu"] = L.i_("nmu")
    d["nph_lc"] = L.i_("nph_lc")
    lc = []
    for q in range(d["nph_lc"]):
        lo = L.f(f"lc_band[{q}].E_lo")
        hi = L.f(f"lc_band[{q}].E_hi")
        lc.append((lo, hi))
    d["lc_bands"] = lc
    d["spname"] = L.s("spname")
    d["phname"] = L.s("phname")
    d["lcname"] = L.s("lcname")
    d["eventfile"] = L.s("eventfile")
    d["temp_file"] = L.s("temp_file")
    d["nst"] = L.i_("nst")
    d["rseed"] = L.i_("rseed")
    d["rand_switch"] = L.i_("rand_switch")
    d["cr_sent"] = L.i_("cr_sent")
    d["upper_sent"] = L.i_("upper_sent")
    d["dh_sentinel"] = L.i_("dh_sentinel")
    d["pair_switch"] = L.i_("pair_switch")
    d["T_const"] = L.i_("T_const")
    d["cf_sentinel"] = L.i_("cf_sentinel")
    d["r_flare"] = L.f("r_flare")
    d["z_flare"] = L.f("z_flare")
    d["t_flare"] = L.f("t_flare")
    d["sigma_r"] = L.f("sigma_r")
    d["sigma_z"] = L.f("sigma_z")
    d["sigma_t"] = L.f("sigma_t")
    d["flare_amp"] = L.f("flare_amp")
    d["r_esc"] = L.f("r_esc")
    d["r_acc"] = L.f("r_acc")
    d["inj_switch"] = L.i_("inj_switch")
    d["inj_dis"] = L.i_("inj_dis")
    d["g2var_switch"] = L.i_("g2var_switch")
    d["pick_sw"] = L.i_("pick_sw")
    d["inj_g1"] = L.f("inj_g1")
    d["inj_g2"] = L.f("inj_g2")
    d["inj_p"] = L.f("inj_p")
    d["inj_t"] = L.f("inj_t")
    d["inj_L"] = L.f("inj_L")
    d["pick_rate"] = L.f("pick_rate")
    d["inj_gg"] = L.f("inj_gg")
    d["inj_sigma"] = L.f("inj_sigma")
    d["g_bulk"] = L.f("g_bulk")
    d["R_blr"] = L.f("R_blr")
    d["fr_blr"] = L.f("fr_blr")
    d["R_ir"] = L.f("R_ir")
    d["fr_ir"] = L.f("fr_ir")
    d["R_disk"] = L.f("R_disk")
    d["d_jet"] = L.f("d_jet")
    d["split1"] = L.i_("split1")
    d["split2"] = L.i_("split2")
    d["split3"] = L.i_("split3")
    d["spl3_trg"] = L.i_("spl3_trg")
    _validate_input(path, d)
    return d


def _validate_input(path: str, d: dict) -> None:
    """Cross-field consistency checks — the reader.f errors.txt role
    (reader.f:153,170-201): every failure names the offending field."""
    errs = []
    if d["r_max"] <= d["r_min"]:
        errs.append(
            f"r_max={d['r_max']:g} must exceed r_min={d['r_min']:g}"
        )
    if d["z_max"] <= 0.0:
        errs.append(f"z_max={d['z_max']:g} must be positive")
    if d["tstop"] <= 0.0:
        errs.append(f"tstop={d['tstop']:g} must be positive")
    if d["mcdt"] <= 0.0:
        errs.append(f"mcdt={d['mcdt']:g} must be positive")
    prev_t1 = None
    for t, w in enumerate(d["windows"]):
        if w["t1"] <= w["t0"]:
            errs.append(
                f"window[{t}]: t1={w['t1']:g} must exceed t0={w['t0']:g}"
            )
        if prev_t1 is not None and w["t0"] < prev_t1:
            errs.append(
                f"window[{t}]: t0={w['t0']:g} overlaps the previous "
                f"window ending at {prev_t1:g} (windows must be "
                f"time-ordered, imcgen2d.f:111-120 picks by time+dt/2)"
            )
        prev_t1 = w["t1"]
        for k in range(d["nr"]):
            for side, tb, fn in (
                ("upper", w["tbbu"][k], w["ufn"][k]),
                ("lower", w["tbbl"][k], w["lfn"][k]),
            ):
                if tb < 0.0 and not fn:
                    errs.append(
                        f"window[{t}].tbb_{side}[{k}] < 0 requests an "
                        f"external spectrum file but the name line is "
                        f"empty (reader.f:222-283)"
                    )
    prev_hi = None
    for q, (emin, emax, nb) in enumerate(d["regions"]):
        if emax <= emin or emin <= 0.0:
            errs.append(
                f"region[{q}]: [{emin:g}, {emax:g}] keV must be "
                f"positive and increasing"
            )
        if nb < 1:
            errs.append(f"region[{q}]: nbins={nb} must be >= 1")
        if prev_hi is not None and abs(emin - prev_hi) > 1e-9 * prev_hi:
            errs.append(
                f"region[{q}]: E_min={emin:g} must continue the "
                f"previous region's E_max={prev_hi:g} (the spectral "
                f"grid is contiguous, setup2d.f:163-173)"
            )
        prev_hi = emax
    for q, (lo, hi) in enumerate(d["lc_bands"]):
        if hi <= lo or lo <= 0.0:
            errs.append(
                f"lc_band[{q}]: [{lo:g}, {hi:g}] keV must be positive "
                f"and increasing"
            )
    if d["nmu"] < 1:
        errs.append(f"nmu={d['nmu']} must be >= 1")
    if d["nst"] < 1:
        errs.append(f"nst={d['nst']} must be >= 1")
    for name in ("split1", "split2", "split3"):
        if d[name] < 1:
            errs.append(f"{name}={d[name]} must be >= 1")
    if d["pair_switch"] not in (0, 1):
        errs.append(f"pair_switch={d['pair_switch']} must be 0 or 1")
    if d["cr_sent"] not in (0, 1, 2, 3, 4):
        errs.append(
            f"cr_sent={d['cr_sent']} must be in 0..4 (reader.f:476-486)"
        )
    if d["g_bulk"] < 1.0:
        errs.append(f"g_bulk={d['g_bulk']:g} must be >= 1")
    if errs:
        raise LegacyConfigError(
            f"{path}: {len(errs)} invalid field(s):\n  - "
            + "\n  - ".join(errs)
        )


def parse_zone_file(path: str) -> dict:
    """input/input_JJ_KK.dat (reader.f:630-642)."""
    L = _Lines(path)
    return dict(
        tea=L.f("tea"), tna=L.f("tna"), n_e=L.f("n_e"),
        ep_switch=L.i_("ep_switch"), B_field=L.f("B_field"),
        amxwl=L.f("amxwl"), gmin=L.f("gmin"), gmax=L.f("gmax"),
        p_nth=L.f("p_nth"), q_turb=L.f("q_turb"),
        turb_lev=L.f("turb_lev"),
    )


def config_echo(d: dict) -> str:
    """Human-readable echo of every parsed input.dat field — the
    reference's log.txt config echo role (reader.f:170-201 writes each
    field back to unit 4 as it is read)."""
    out = ["# input.dat echo (reader.f field order)"]
    for key, val in d.items():
        if key == "windows":
            for t, w in enumerate(val):
                out.append(
                    f"window[{t}]: t=[{w['t0']:g}, {w['t1']:g}] s"
                )
                out.append(f"  tbb_upper = {w['tbbu']}")
                out.append(f"  tbb_lower = {w['tbbl']}")
                for k, fn in enumerate(w["ufn"]):
                    if w["tbbu"][k] < 0.0:
                        out.append(f"  upper_spectrum[{k}] = {fn}")
                for k, fn in enumerate(w["lfn"]):
                    if w["tbbl"][k] < 0.0:
                        out.append(f"  lower_spectrum[{k}] = {fn}")
        else:
            out.append(f"{key} = {val}")
    return "\n".join(out) + "\n"


def load_legacy_config(
    input_dir: str, echo_path: Optional[str] = None, **run_overrides
) -> LegacyConfig:
    """Load a full reference-style config directory.

    ``echo_path``: write a full config echo there after a successful
    parse (the reference's log.txt echo, reader.f:170-201)."""
    d = parse_input_dat(os.path.join(input_dir, "input.dat"))
    if echo_path:
        with open(echo_path, "w") as fh:
            fh.write(config_echo(d))
    nz, nr = d["nz"], d["nr"]

    grid = GridConfig(
        nz=nz, nr=nr, z_max=d["z_max"], r_min=d["r_min"],
        r_max=d["r_max"],
        spectral_regions=tuple(d["regions"]),
        nmu=d["nmu"],
        lc_bands=tuple(d["lc_bands"]),
    )
    def _resolve(name: str) -> str:
        """Spectrum filenames in input.dat are relative to the run
        directory (the parent of input/); accept either location."""
        if not name or os.path.isabs(name):
            return name
        for cand in (
            os.path.join(input_dir, name),
            os.path.join(os.path.dirname(os.path.abspath(input_dir)),
                         name),
            name,
        ):
            if os.path.exists(cand):
                return cand
        return name

    windows = tuple(
        TimeWindow(
            t0=w["t0"], t1=w["t1"],
            tbb_lower=tuple(w["tbbl"]),
            tbb_upper=tuple(w["tbbu"]),
            tbb_inner=(0.0,) * nz,
            tbb_outer=(0.0,) * nz,
            # per-ring per-window spectrum files (reader.f:228-246); the
            # name line is only meaningful where tbb < 0
            upper_spectra=tuple(
                _resolve(w["ufn"][k]) if w["tbbu"][k] < 0.0 else None
                for k in range(nr)
            ),
            lower_spectra=tuple(
                _resolve(w["lfn"][k]) if w["tbbl"][k] < 0.0 else None
                for k in range(nr)
            ),
        )
        for w in d["windows"]
    )
    inj_v = float(np.sqrt(max(1.0 - 1.0 / d["g_bulk"] ** 2, 1e-12))
                  * cn.C_LIGHT) if d["g_bulk"] > 1.0 else cn.C_LIGHT
    phys = PhysicsConfig(
        cr_sent=d["cr_sent"], upper_sent=d["upper_sent"],
        dh_sentinel=d["dh_sentinel"], pair_switch=d["pair_switch"],
        t_const=bool(d["T_const"]),
        star_switch=d["star_switch"], r_star=d["r_star"],
        dist_star=d["dist_star"],
        r_esc=d["r_esc"], r_acc=d["r_acc"],
        flare=FlareConfig(
            enabled=bool(d["cf_sentinel"]),
            r_flare=d["r_flare"], z_flare=d["z_flare"],
            t_flare=d["t_flare"], sigma_r=d["sigma_r"],
            sigma_z=d["sigma_z"], sigma_t=d["sigma_t"],
            amplitude=d["flare_amp"],
        ),
        injection=InjectionConfig(
            switch=d["inj_switch"], distribution=d["inj_dis"],
            g1=d["inj_g1"], g2=d["inj_g2"], p=d["inj_p"],
            t_start=d["inj_t"], gauss_g=d["inj_gg"],
            gauss_sigma=d["inj_sigma"], luminosity=d["inj_L"],
            v=inj_v, g2var_switch=d["g2var_switch"],
            pickup=bool(d["pick_sw"]), pickup_rate=d["pick_rate"],
        ),
    )
    source = SourceConfig(
        nst=d["nst"],
        split=max(d["split1"], 1),
        external=ExternalRadiationConfig(
            R_blr=d["R_blr"], fr_blr=d["fr_blr"],
            R_ir=d["R_ir"], fr_ir=d["fr_ir"],
            R_disk=d["R_disk"], d_jet=d["d_jet"],
            g_bulk=d["g_bulk"],
        ),
    )
    run = RunConfig(
        t_stop=d["tstop"], mcdt=d["mcdt"], seed=d["rseed"],
        **run_overrides,
    )
    cfg = SimConfig(
        grid=grid, physics=phys, source=source, run=run, windows=windows
    )

    # per-zone files; a missing file is named up front rather than
    # surfacing as FileNotFoundError deep in a loop (the reference
    # expects exactly nz*nr of them, reader.f:608-612)
    missing = [
        f"input_{j + 1:02d}_{k + 1:02d}.dat"
        for j in range(nz) for k in range(nr)
        if not os.path.exists(os.path.join(
            input_dir, f"input_{j + 1:02d}_{k + 1:02d}.dat"
        ))
    ]
    if missing:
        raise LegacyConfigError(
            f"{input_dir}: nz*nr = {nz}*{nr} per-zone files expected "
            f"(reader.f:608-612); {len(missing)} missing: "
            + ", ".join(missing[:6])
            + ("..." if len(missing) > 6 else "")
        )
    z = ZoneInit.uniform(grid)
    for j in range(nz):
        for k in range(nr):
            path = os.path.join(
                input_dir, f"input_{j + 1:02d}_{k + 1:02d}.dat"
            )
            zd = parse_zone_file(path)
            for name, val in zd.items():
                getattr(z, name)[j, k] = val

    # first file-spectrum boundary (back-compat convenience)
    spectrum_files = {}
    for w in d["windows"]:
        for k in range(nr):
            if w["tbbl"][k] < 0 and w["lfn"][k]:
                spectrum_files.setdefault("lower", _resolve(w["lfn"][k]))
            if w["tbbu"][k] < 0 and w["ufn"][k]:
                spectrum_files.setdefault("upper", _resolve(w["ufn"][k]))

    return LegacyConfig(
        cfg=cfg, zones=z,
        filenames=dict(
            spname=d["spname"], phname=d["phname"], lcname=d["lcname"],
            eventfile=d["eventfile"], temp_file=d["temp_file"],
        ),
        spectrum_files=spectrum_files,
        seed=d["rseed"],
        splits=(d["split1"], d["split2"], d["split3"], d["spl3_trg"]),
    )


# ---------------------------------------------------------------------------
# External (disk/BLR/IR) spectrum files — file_sp
# ---------------------------------------------------------------------------
def external_spectrum(
    fname: str,
    ext: ExternalRadiationConfig,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """file_sp (imcsurf2d_para.f:544-685): read the 4-column spectrum
    (E [keV], L_disk, F_blr, F_ir), normalize the BLR and torus fluxes to
    the Ghisellini-Madau comoving-frame energy densities boosted by
    Gamma^2, and build the piecewise-power-law sampling CDF.

    Returns (E_file, F_file, P_file CDF, int_file [erg/cm^2/s]).
    """
    data = np.loadtxt(fname)
    e = data[:, 0]
    l_disk = data[:, 1]
    f_blr = data[:, 2]
    f_ir = data[:, 3]
    n = len(e)
    de = np.diff(e)
    ratio = np.sqrt(e[1] / e[0])

    ltot = np.sum(l_disk[:-1] * de) / ratio
    fblr_tot = np.sum(f_blr[:-1] * de) / ratio
    fir_tot = np.sum(f_ir[:-1] * de) / ratio

    g2 = ext.g_bulk**2
    fblr_norm = 17.0 / 48.0 / np.pi * g2 * ext.fr_blr * ltot / ext.R_blr**2
    fir_norm = 0.25 / np.pi * g2 * ext.fr_ir * ltot / ext.R_ir**2
    f_file = (
        f_blr / max(fblr_tot, 1e-300) * fblr_norm
        + f_ir / max(fir_tot, 1e-300) * fir_norm
    )

    # piecewise-power-law integrals (imcsurf2d_para.f:659-682)
    f_file = np.maximum(f_file, 1e-300)
    alpha = np.log(f_file[1:] / f_file[:-1]) / np.log(e[1:] / e[:-1])
    a1 = np.clip(alpha + 1.0, -20.0, 20.0)
    seg = np.where(
        np.abs(a1) < 1e-3,
        f_file[:-1] * e[:-1] * np.log(e[1:] / e[:-1]),
        f_file[:-1] * e[:-1] * ((e[1:] / e[:-1]) ** a1 - 1.0) / a1,
    )
    isum = np.sum(seg)
    cdf = np.cumsum(seg) / max(isum, 1e-300)
    p_file = np.concatenate([[0.0], cdf])
    return e, f_file, p_file, float(isum)
