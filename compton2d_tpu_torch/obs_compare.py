"""The computed Mrk 421 SED against the observed SED points (the port's
counterpart of ``tools/obs_compare.py``).

``compare`` is the reference tool's comparison, with the same summary
keys: the model's nuFnu at Earth (``sed.dat``'s fourth column, from
``run_mrk421``) against each observed dataset at the X-ray anchors (2 and
10 keV) and the TeV anchors (0.5 and 1 TeV), the global renormalisation
s* fitted to the X-ray anchors, the TeV residual under it, the
synchrotron and SSC peaks and the overlay table.

The observed points are read from an overlay that the reference tool
wrote (``load_obs_overlay``: the ``is_obs = 1`` rows of
``artifacts/mrk421_dense/obs_compare.dat``, which hold every point it
loaded from the reference's observation files, printed to 7 digits), so
the comparison runs from the repository alone. ``compare`` never reads
the points' error bars, which the overlay does not keep.

  python -m compton2d_tpu_torch.obs_compare --sed mrk421_out/sed.dat
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVERLAY_DEFAULT = os.path.join(REPO, "artifacts", "mrk421_dense",
                               "obs_compare.dat")
# the overlay's dataset tags and the reference tool's dataset names
DATASETS = (
    ("xray_flare_2001", "xray_flare_2001 (x_newa1)"),
    ("xray_low_2001", "xray_low_2001 (rxte)"),
    ("xray_veryhigh_2001", "xray_veryhigh_2001 (rxte)"),
    ("xray_low_1998", "xray_low_1998 (sax)"),
    ("xray_high_1998", "xray_high_1998 (sax)"),
    ("tev_2001", "tev_2001 (g_newa1)"),
)
TEV = "tev_2001 (g_newa1)"

Obs = Dict[str, Tuple[np.ndarray, np.ndarray, None]]


def load_obs_overlay(dat: str = OVERLAY_DEFAULT) -> Obs:
    """{reference dataset name: (E_keV, nuFnu, None)} from the observed
    rows of an overlay table, in the file's order."""
    names = dict(DATASETS)
    pts: Dict[str, list] = {name: [] for _tag, name in DATASETS}
    with open(dat) as fh:
        for line in fh:
            t = line.split()
            if not t or t[0].startswith("#") or t[2] != "1":
                continue
            if t[3] not in names:
                raise ValueError(f"{dat}: unknown dataset {t[3]!r}")
            pts[names[t[3]]].append((float(t[0]), float(t[1])))
    out = {}
    for name, rows in pts.items():
        if not rows:
            raise ValueError(f"{dat}: no points of {name}")
        a = np.asarray(rows, np.float64)
        out[name] = (a[:, 0], a[:, 1], None)
    return out


def _interp_log(e_q, e, f):
    """log-log interpolation of f(e) at e_q, NaN outside the range."""
    sel = f > 0
    if sel.sum() < 2:
        return np.full(np.shape(e_q), np.nan)
    le, lf = np.log10(e[sel]), np.log10(f[sel])
    o = np.argsort(le)
    out = np.interp(np.log10(e_q), le[o], lf[o], left=np.nan,
                    right=np.nan)
    return 10.0 ** out


def compare(sed_path: str, obs: Obs, out_dir: Optional[str] = None,
            obs_source: str = OVERLAY_DEFAULT) -> dict:
    """The reference tool's summary of ``sed_path`` against ``obs``;
    with ``out_dir``, also writes its obs_compare.dat and .json there."""
    sed = np.loadtxt(sed_path)
    if sed.ndim != 2 or sed.shape[1] < 4:
        raise ValueError(f"{sed_path} has no nuFnu_earth column")
    e_mod, counts, nufnu_mod = sed[:, 0], sed[:, 2], sed[:, 3]

    anchors_x = np.array([2.0, 10.0])            # keV
    anchors_t = np.array([5.0e8, 1.0e9])         # keV (0.5, 1 TeV)
    mod_x = _interp_log(anchors_x, e_mod, nufnu_mod)
    mod_t = _interp_log(anchors_t, e_mod, nufnu_mod)

    table = {}
    ratios_x = []
    with np.errstate(divide="ignore", invalid="ignore"):
        for name, (e, f, _err) in obs.items():
            xray = name.startswith("xray")
            anchors, mod = (anchors_x, mod_x) if xray else (anchors_t, mod_t)
            ov = _interp_log(anchors, e, f)
            table[name] = {
                "anchor_keV": anchors.tolist(),
                "obs_nufnu": ov.tolist(),
                "model_nufnu": mod.tolist(),
                "log10_model_over_obs": np.log10(mod / ov).tolist(),
            }
            if xray:
                ratios_x.extend(np.log10(mod / ov)[np.isfinite(ov * mod)])

        # one free filling factor fitted to the X-ray anchors; the TeV
        # residual under it is the SSC-consistency statement
        s_star_log10 = (float(-np.nanmedian(ratios_x)) if ratios_x
                        else np.nan)
        tev_obs = _interp_log(anchors_t, *obs[TEV][:2])
        tev_resid = np.log10(mod_t * 10.0 ** s_star_log10 / tev_obs)

    pos = nufnu_mod > 0
    lo = pos & (e_mod < 1e3)
    hi = pos & (e_mod >= 1e3)
    sync_peak = (float(e_mod[lo][np.argmax(nufnu_mod[lo])]) if lo.any()
                 else None)
    ssc_peak = (float(e_mod[hi][np.argmax(nufnu_mod[hi])]) if hi.any()
                else None)

    summary = {
        "sed": os.path.abspath(sed_path),
        "obs_dir": os.path.abspath(obs_source),
        "model_sync_peak_keV_obs": sync_peak,
        "model_ssc_peak_keV_obs": ssc_peak,
        # Mrk 421's synchrotron peak sits at ~0.1-several keV
        "sync_peak_in_obs_decade": bool(
            sync_peak is not None and 1e-2 <= sync_peak <= 1e1),
        "per_dataset": table,
        "xray_log10_model_over_obs_median": (
            float(np.nanmedian(ratios_x)) if ratios_x else None),
        "global_renorm_log10": s_star_log10,
        "tev_log10_residual_after_renorm": [
            None if not np.isfinite(v) else float(v) for v in tev_resid],
        "n_tev_model_records": float(
            counts[(e_mod >= 1e9) & (e_mod < 1e10)].sum()),
    }

    if out_dir is not None:
        rows = [(e_mod[i], nufnu_mod[i], 0, "model")
                for i in range(len(e_mod)) if nufnu_mod[i] > 0]
        for name, (e, f, _err) in obs.items():
            rows.extend((e[j], f[j], 1, name.split()[0])
                        for j in range(len(e)))
        with open(os.path.join(out_dir, "obs_compare.dat"), "w") as fh:
            fh.write("# E_obs[keV]  nuFnu[erg/cm^2/s]  is_obs  dataset\n")
            for e, f, o, tag in rows:
                fh.write(f"{e:14.6e} {f:14.6e} {o} {tag}\n")
        with open(os.path.join(out_dir, "obs_compare.json"), "w") as fh:
            json.dump(summary, fh, indent=1)
    return summary


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sed", required=True)
    ap.add_argument("--overlay", default=OVERLAY_DEFAULT,
                    help="an overlay table whose is_obs rows are the "
                    "observed points")
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args()
    s = compare(args.sed, load_obs_overlay(args.overlay), args.out_dir,
                args.overlay)
    print(json.dumps({k: v for k, v in s.items() if k != "per_dataset"},
                     indent=1))


if __name__ == "__main__":
    main()
