"""Seed spread of the Mrk 421 run's SED against a reference sed.dat.

Runs ``run_mrk421`` once per seed in one process, each into
``<out>/seed<k>``, and prints one JSON line per seed and one for the
reference: the raw synchrotron peak (the argmax bin, ``sync_peak_keV_obs``
of summary.json), the hump's centre (``run_mrk421.sync_centroid_kev``), the
heaviest bin's share of the sync band's nuFnu, the SSC peak and the record
counts. The last line gives each statistic's range over the seeds::

  python -m compton2d_tpu_torch.mrk421_seeds --seeds 0 1 2 3 \\
      --reference artifacts/mrk421_dense/sed.dat --nst 200000 \\
      --n-slots 131072 --n-e 2e6 --strat-gamma-c 3e4 --strat-copies 64 \\
      --out mrk421_out/seeds
"""
from __future__ import annotations

import copy
import json
import os

import numpy as np

from compton2d_tpu_torch import run_mrk421


def sync_stats(sed_table: np.ndarray) -> dict:
    """Raw peak, centroid and heaviest-bin share of a sed.dat table's
    synchrotron band (below 1 MeV observed)."""
    e_mid, nufnu = sed_table[:, 0], sed_table[:, 1]
    lo = (e_mid < 1e3) & (nufnu > 0)
    return {
        "sync_peak_keV_obs": float(e_mid[lo][np.argmax(nufnu[lo])]),
        "sync_centroid_keV": run_mrk421.sync_centroid_kev(sed_table),
        "top_bin_share": float(nufnu[lo].max() / nufnu[lo].sum()),
    }


def main(argv=None):
    ap = run_mrk421.parser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--reference", default=None,
                    help="a reference sed.dat to set beside the seeds")
    args = ap.parse_args(argv)
    rows = []
    for seed in args.seeds:
        a = copy.copy(args)
        a.seed, a.out = seed, os.path.join(args.out, f"seed{seed}")
        summary = run_mrk421.run(a, verbose=False)
        row = {"seed": seed,
               **sync_stats(np.loadtxt(os.path.join(a.out, "sed.dat"))),
               **{k: summary[k] for k in (
                   "ssc_peak_keV_obs", "tev_band_records_all_mu",
                   "n_event_records", "balance", "wall_s")}}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.reference:
        print(json.dumps({"reference": args.reference,
                          **sync_stats(np.loadtxt(args.reference))}))
    spread = {}
    for k in ("sync_peak_keV_obs", "sync_centroid_keV", "top_bin_share",
              "ssc_peak_keV_obs"):
        vals = [r[k] for r in rows if r[k] is not None]
        spread[k] = [min(vals), max(vals)] if vals else None
    print(json.dumps({"seeds": args.seeds, "range": spread}))


if __name__ == "__main__":
    main()
