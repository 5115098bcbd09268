"""Figure of merit of the stratified tail splitting (the counterpart of
``tools/strat_fom.py``).

Runs the Mrk 421 workload at its SSC-resolved density (n_e 2e6) with
``strat_split`` off, on at the default tail boundary (gamma_c 1e3, one
copy) and on at the TeV setting of the committed artifact (gamma_c 3e4,
64 copies), from the same seed for the same steps, and reports per
light-curve band the records, the time-integrated Doppler-boosted flux,
its relative Monte-Carlo error sigma_rel = sqrt(sum ew^2) / sum ew and
the figure of merit FOM = 1 / (sigma_rel^2 t_wall), with the ratios of
the FOMs to the unsplit run's::

  python -m compton2d_tpu_torch.strat_fom --steps 12 --nst 20000
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time

import numpy as np
import torch

from compton2d_tpu_torch.examples import MRK421_BANDS, MRK421_GAMMA, mrk421
from compton2d_tpu_torch.io.events import EventArrayStore
from compton2d_tpu_torch.io.postprocess import doppler_transform

# (label, strat_split, strat_gamma_c, strat_copies)
RUNS = (("off", False, 1.0e3, 1), ("on(gc=1e3,M=1)", True, 1.0e3, 1),
        ("tev(gc=3e4,M=64)", True, 3.0e4, 64))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def band_errors(ev: np.ndarray, r_max: float, wall: float) -> list:
    """Per band: records, flux, sigma_rel and FOM of the event records."""
    if len(ev):
        tr = doppler_transform(ev, MRK421_GAMMA, r_max)
        E, ew = tr[:, 1], tr[:, 2]
    else:
        E = ew = np.zeros((0,))
    res = []
    for e0, e1 in MRK421_BANDS:
        sel = (E >= e0) & (E < e1)
        f = float(ew[sel].sum())
        f2 = float((ew[sel] ** 2).sum())
        sig = math.sqrt(f2) / f if f > 0 else math.inf
        fom = 1.0 / (sig ** 2 * wall) if math.isfinite(sig) and sig > 0 \
            else 0.0
        res.append(dict(band_keV=[e0, e1], n=int(sel.sum()), flux=f,
                        sigma_rel=sig, fom=fom))
    return res


def run(strat: bool, steps: int, nst: int, gamma_c: float = 1.0e3,
        copies: int = 1, device="cuda", **sizes) -> tuple:
    """(seconds of the timed steps, band_errors) of one run: one step to
    build and warm up, then ``steps`` timed steps whose events count.
    ``sizes`` overrides ``mrk421``'s grid and slots (the tests' small
    runs)."""
    kw = dict(n_slots=1 << 16)
    kw.update(sizes)
    sim = mrk421(nst=nst, n_e=2.0e6, device=device, **kw)
    sim = sim.with_config(dataclasses.replace(
        sim.cfg, source=dataclasses.replace(
            sim.cfg.source, strat_split=strat, strat_gamma_c=gamma_c,
            strat_copies=copies)))
    store = EventArrayStore(sim.scales.E)
    sim.step()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        out = sim.step()
        store.write(out.events)
    _sync(device)
    wall = time.perf_counter() - t0
    return wall, band_errors(store.all(), sim.cfg.grid.r_max, wall)


def _finite(x):
    return x if math.isfinite(x) else None


def compare(steps: int, nst: int, device="cuda", **sizes) -> dict:
    """Every run of RUNS, and per band the errors and FOM ratios. A short
    untimed run first takes the process's one-time set-up (the card's
    context, library handles, the allocator's growth) out of the first
    run's wall time."""
    run(False, 1, nst, device=device, **sizes)
    walls, bands = {}, {}
    for label, strat, gc, m in RUNS:
        walls[label], bands[label] = run(strat, steps, nst, gc, m, device,
                                         **sizes)
    rows = []
    base = bands[RUNS[0][0]]
    for i, b0 in enumerate(base):
        row = {"band_keV": b0["band_keV"]}
        for label, *_ in RUNS:
            b = bands[label][i]
            row[f"n[{label}]"] = b["n"]
            row[f"sigma_rel[{label}]"] = _finite(b["sigma_rel"])
            if b0["fom"] > 0:
                ratio = b["fom"] / b0["fom"]
            else:
                ratio = math.inf if b["fom"] > 0 else 0.0
            row[f"fom_ratio[{label}/off]"] = _finite(ratio)
        rows.append(row)
    return {"steps": steps, "nst": nst, "wall_s": walls, "bands": rows}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--nst", type=int, default=20000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    print(json.dumps(compare(args.steps, args.nst, args.device), indent=1))


if __name__ == "__main__":
    main()
