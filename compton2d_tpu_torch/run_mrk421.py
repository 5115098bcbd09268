"""Run the Mrk 421 SSC flare workload to t_stop and write its science
artifact (the port's counterpart of ``tools/run_mrk421.py``).

1. runs ``examples.mrk421`` to t_stop = 7e4 s (comoving) with stratified
   tail splitting and outputs attached (event records in the reference's
   7-column format);
2. post-processes the escaping-photon events (the native library's
   binning, ``io.native``): Doppler-boosted 7-band light curves at the
   reference's 700-s observed cadence and the time-integrated SED;
3. writes sed.dat (E, nuFnu, counts, nuFnu at Earth), lc.dat (t, 7 band
   rates) and summary.json (peak locations, fluxes, run metadata) into
   ``--out``, with the keys of the reference's summary.json.

Runs on the CUDA card unless ``--device cpu`` is given::

  python -m compton2d_tpu_torch.run_mrk421 --nst 200000 \\
      --n-slots 131072 --n-e 2e6 --strat-gamma-c 3e4 --strat-copies 64 \\
      --out mrk421_out/dense
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from compton2d_tpu_torch import telemetry as tm
from compton2d_tpu_torch.examples import MRK421_BANDS, mrk421
from compton2d_tpu_torch.io import native
from compton2d_tpu_torch.io import postprocess as pp

GAMMA_BULK = 33.0          # postprocessing/mrk421_lc.input:2
T_BIN_OBS = 700.0          # observed-frame cadence [s] (:13)
MU_RANGE = (0.99944, 0.99964)  # observer cone (:5-6 pattern)
# Mrk 421: z = 0.031, d_L ~ 134 Mpc (H0 = 71)
D_L_CM = 4.14e26


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nst", type=int, default=60000)
    ap.add_argument("--n-slots", type=int, default=1 << 17)
    ap.add_argument("--out", default="mrk421_out")
    ap.add_argument("--t-stop", type=float, default=7.0e4)
    # stratified tail splitting on by default: the blob is optically thin,
    # so un-split SSC scatters are rare and the GeV-TeV bands would stay
    # empty at any feasible nst
    ap.add_argument("--no-strat", dest="strat", action="store_false",
                    default=True)
    # tail-stratum boundary: gamma_c ~ 3e4 targets the TeV band
    ap.add_argument("--strat-gamma-c", type=float, default=1.0e3)
    # tail copies per scatter (the reference's split3 analogue)
    ap.add_argument("--strat-copies", type=int, default=1)
    ap.add_argument("--n-e", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def make_sim(args):
    """The mrk421 Simulation with the run's flags applied."""
    sim = mrk421(nst=args.nst, n_slots=args.n_slots, n_e=args.n_e,
                 seed=args.seed, device=args.device)
    cfg = dataclasses.replace(
        sim.cfg,
        run=dataclasses.replace(sim.cfg.run, t_stop=args.t_stop),
        source=dataclasses.replace(
            sim.cfg.source, strat_split=args.strat,
            strat_gamma_c=args.strat_gamma_c,
            strat_copies=args.strat_copies,
        ),
    )
    return sim.with_config(cfg)


def postprocess(events: np.ndarray, r_max: float, out_dir: str) -> dict:
    """SED (sed.dat) and light curves (lc.dat) of the event records, and
    the SED's peak summary. The TOF transform uses the grid's own blob
    radius."""
    with tm.span("outputs.postprocess"):
        # SED: full run, log grid over the Doppler-boosted range; weights
        # are in erg. Normalization follows pspt.c (isotropic-equivalent
        # luminosity over the observed duration), then nuFnu at Earth.
        e_edges = np.geomspace(1e-8, 1e11, 150)
        tr = pp.doppler_transform(events, GAMMA_BULK, r_max)
        t_obs_all = tr[:, 0]
        t_span = float(np.percentile(t_obs_all, 99.5)) or 1.0
        s = native.sed(events, GAMMA_BULK, r_max, 0.0, t_span, e_edges,
                       mu_range=MU_RANGE)
        e_mid = np.sqrt(e_edges[1:] * e_edges[:-1])
        de = np.diff(e_edges)
        dmu_half = 0.5 * (MU_RANGE[1] - MU_RANGE[0])
        l_e = s.flux / (t_span * de * dmu_half)     # pspt.c:318-321
        nufnu_earth = e_mid * l_e / (4.0 * np.pi * D_L_CM**2)
        nufnu = e_mid * s.flux / de   # shape-only column
        np.savetxt(
            os.path.join(out_dir, "sed.dat"),
            np.column_stack([e_mid, nufnu, s.counts, nufnu_earth]),
            header=(
                "E_obs[keV]  E*F(E)[erg, shape]  n_records  "
                f"nuFnu_earth[erg/cm^2/s @ d_L={D_L_CM:.3e}cm, "
                f"mu={MU_RANGE[0]}..{MU_RANGE[1]}]"
            ),
            fmt="%14.6e",
        )

        # light curves at the reference cadence
        t_hi = np.percentile(t_obs_all, 99.5)
        t_edges = np.arange(0.0, t_hi + T_BIN_OBS, T_BIN_OBS)
        lc = native.light_curves(events, GAMMA_BULK, r_max, t_edges,
                                 np.asarray(MRK421_BANDS))
        rate = lc.rate().sum(axis=1)   # erg/s, summed over mu bins
        hdr = "t_mid[s] " + " ".join(
            f"band{b}[{lo:g}-{hi:g}keV]"
            for b, (lo, hi) in enumerate(MRK421_BANDS)
        )
        t_mid = 0.5 * (t_edges[1:] + t_edges[:-1])
        np.savetxt(os.path.join(out_dir, "lc.dat"),
                   np.column_stack([t_mid, rate]), header=hdr, fmt="%14.6e")

        # split the SED at 1 MeV: synchrotron peak below, SSC peak above
        lo_m = (e_mid < 1e3) & (nufnu > 0)
        hi_m = (e_mid >= 1e3) & (nufnu > 0)
        tev = (e_mid >= 1e9) & (e_mid < 1e10)
        e_all = tr[:, 1]
        return {
            "sync_peak_keV_obs": (float(e_mid[lo_m][np.argmax(nufnu[lo_m])])
                                  if lo_m.any() else None),
            "ssc_peak_keV_obs": (float(e_mid[hi_m][np.argmax(nufnu[hi_m])])
                                 if hi_m.any() else None),
            "tev_band_nufnu": float(nufnu[tev].sum()),
            "tev_band_records": int(s.counts[tev].sum()),
            # all-angle TeV statistics (the observer cone is ~11% of the
            # comoving sphere)
            "tev_band_records_all_mu": int(np.sum((e_all >= 1e9)
                                                  & (e_all < 1e10))),
            "gev100_records_all_mu": int(np.sum(e_all >= 1e8)),
            "tev_band_nufnu_earth": (float(np.max(nufnu_earth[tev]))
                                     if tev.any() else 0.0),
            "sync_peak_nufnu_earth": float(
                np.max(nufnu_earth[lo_m]) if lo_m.any() else 0.0),
        }


def sync_centroid_kev(sed_table: np.ndarray) -> float:
    """The synchrotron hump's centre [keV, observed] from a sed.dat table:
    the log-energy centroid below 1 MeV of nuFnu after a 5-bin running
    median. The raw peak (``sync_peak_keV_obs``) is the argmax of one bin
    and follows the few heaviest records; the median ignores a lone heavy
    bin."""
    e_mid, nufnu = sed_table[:, 0], sed_table[:, 1]
    lo = e_mid < 1e3
    e_mid, nufnu = e_mid[lo], nufnu[lo]
    smooth = np.array([np.median(nufnu[max(0, i - 2):i + 3])
                       for i in range(nufnu.size)])
    return float(10.0 ** (np.sum(np.log10(e_mid) * smooth) / np.sum(smooth)))


def run(args, verbose: bool = True) -> dict:
    """Run to t_stop, post-process, write summary.json; returns it."""
    os.makedirs(args.out, exist_ok=True)
    sim = make_sim(args)
    sim.attach_outputs(args.out, event_file="evb.dat")
    t0 = time.time()
    done = sim.run_to_stop(verbose=verbose)
    wall = time.time() - t0
    audit = sim.energy_audit()
    if verbose:
        print(f"# completed={done} steps={int(sim.state.ncycle)} "
              f"wall={wall:.1f}s balance={audit['balance']:.6f}")
    events = np.loadtxt(os.path.join(args.out, "evb.dat")).reshape(-1, 7)
    if verbose:
        print(f"# {len(events)} escaping-photon records")
    peaks = postprocess(events, sim.cfg.grid.r_max, args.out)
    dev = torch.device(args.device)
    summary = {
        "gamma_bulk": GAMMA_BULK,
        "t_stop_comoving_s": args.t_stop,
        "nst": args.nst,
        "steps": int(sim.state.ncycle),
        "n_event_records": int(len(events)),
        "balance": float(audit["balance"]),
        **peaks,
        "strat_gamma_c": args.strat_gamma_c,
        "strat_copies": args.strat_copies,
        "mu_range": list(MU_RANGE),
        "d_l_cm": D_L_CM,
        "wall_s": round(wall, 1),
        "backend": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else dev.type),
    }
    with open(os.path.join(args.out, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    return summary


def main(argv=None):
    summary = run(parser().parse_args(argv))
    print(json.dumps(summary, indent=1))


if __name__ == "__main__":
    main()
