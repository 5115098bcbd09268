"""The Mrk 421 run on the CPU, port against reference, over seeds.

Runs ``mrk421`` at the dense artifact's widths (10x4 zones, 200 gamma and
400 energy bins, n_e = 2e6, stratified splitting with gamma_c = 3e4) but a
quarter of its photons and slots and 8 copies, to t_stop (13 steps), in
both packages and one process per side and seed, each into
``<out>/<side>_<seed>``. For each run it prints one JSON line: the event
count, the SED's raw synchrotron peak, the hump's centre
(``run_mrk421.sync_centroid_kev``) and the heaviest bin's share of the
sync band (both sides post-processed by the port's ``run_mrk421``), the
SSC peak, the mean zone temperature, the mean Lorentz factor of the
zones' electron spectra after the last FP step, and the observation
check's readings of the SED (``obs_compare.compare`` against the
committed overlay's points: its sync peak, the X-ray median log ratio,
s* and the TeV residuals at 0.5 and 1 TeV). The last line gives each
side's means and its range over the seeds. ``--ftz`` adds the port with float32 denormals flushed.
Not a test (it takes minutes)::

  python tests/compare_mrk421.py --seeds 0 1 2 3 --ftz --out /tmp/cmp
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np

KEYS = ("n_events", "sync_peak_keV_obs", "sync_centroid_keV",
        "top_bin_share", "ssc_peak_keV_obs", "tea_mean", "mean_gamma",
        "obs_sync_peak_keV", "obs_xray_log10_median", "obs_renorm_log10",
        "obs_tev_resid_0p5", "obs_tev_resid_1")


def one(side: str, seed: int, nst: int, out: str) -> dict:
    """One run of ``side`` to t_stop: "jax", "port", or "port_ftz" (the
    port with float32 denormals flushed, as XLA flushes them)."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    import torch

    from compton2d_tpu_torch import mrk421_seeds, obs_compare, run_mrk421
    torch.set_num_threads(2)
    kw = dict(nz=10, nr=4, nst=nst, n_slots=1 << 15, n_e=2e6, seed=seed)
    if side == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        from compton2d_tpu import examples as ex
    else:
        from compton2d_tpu_torch import examples as ex
        kw["device"] = "cpu"
        torch.set_flush_denormal(side == "port_ftz")
    sim = ex.mrk421(**kw)
    sim = sim.with_config(dataclasses.replace(
        sim.cfg, source=dataclasses.replace(
            sim.cfg.source, strat_split=True, strat_gamma_c=3e4,
            strat_copies=8)))
    os.makedirs(out, exist_ok=True)
    sim.attach_outputs(out)
    assert sim.run_to_stop()
    z = sim.state.zones
    f_nt, tea = np.asarray(z.f_nt), np.asarray(z.tea)
    gamma = np.asarray(sim.tables.gnt) + 1.0
    events = np.loadtxt(os.path.join(out, "evb.dat")).reshape(-1, 7)
    peaks = run_mrk421.postprocess(events, sim.cfg.grid.r_max, out)
    sed = mrk421_seeds.sync_stats(np.loadtxt(os.path.join(out, "sed.dat")))
    obs = obs_compare.compare(os.path.join(out, "sed.dat"),
                              obs_compare.load_obs_overlay())
    tev = obs["tev_log10_residual_after_renorm"]
    return {"side": side, "seed": seed, "n_events": int(len(events)), **sed,
            "ssc_peak_keV_obs": peaks["ssc_peak_keV_obs"],
            "obs_sync_peak_keV": obs["model_sync_peak_keV_obs"],
            "obs_xray_log10_median": obs["xray_log10_model_over_obs_median"],
            "obs_renorm_log10": obs["global_renorm_log10"],
            "obs_tev_resid_0p5": tev[0], "obs_tev_resid_1": tev[1],
            "tea_mean": float(tea.mean()),
            "mean_gamma": float(np.mean((f_nt * gamma).sum(-1)
                                        / f_nt.sum(-1)))}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--nst", type=int, default=50000)
    ap.add_argument("--out", required=True)
    ap.add_argument("--ftz", action="store_true",
                    help="also run the port with denormals flushed")
    ap.add_argument("--one", nargs=2, metavar=("SIDE", "SEED"))
    args = ap.parse_args()
    if args.one:
        side, seed = args.one[0], int(args.one[1])
        row = one(side, seed, args.nst, os.path.join(args.out,
                                                     f"{side}_{seed}"))
        print(json.dumps(row))
        return
    sides = ("jax", "port") + (("port_ftz",) if args.ftz else ())
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
         os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--nst", str(args.nst), "--out", args.out,
         "--one", side, str(seed)], stdout=subprocess.PIPE, text=True,
        env=env) for seed in args.seeds for side in sides]
    rows = []
    for p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"a run failed ({p.returncode})")
        rows.append(json.loads(out.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    def vals(side, k):
        return [r[k] for r in rows if r["side"] == side and r[k] is not None]

    means = {side: {k: float(np.mean(vals(side, k))) for k in KEYS}
             for side in sides}
    ranges = {side: {k: [float(min(vals(side, k))), float(max(vals(side, k)))]
                     for k in KEYS if vals(side, k)} for side in sides}
    print(json.dumps({"seeds": args.seeds, "nst": args.nst, "means": means,
                      "ranges": ranges}))


if __name__ == "__main__":
    main()
