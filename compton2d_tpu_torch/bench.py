"""The port's benchmark: photon histories per second on one card
(counterpart of the repository root's ``bench.py``).

Prints one JSON record as its last line, with ``bench.py``'s keys and
meanings, less ``vs_baseline`` (the reference's ratio to its own first
recorded number, which says nothing of this card)::

  {"metric": "photon_histories_per_sec_per_chip", "value": N,
   "unit": "histories/s", "tracking_rounds_per_step": R,
   "step_hbm_model_pct_of_peak": P, "mrk421_histories_per_s": M,
   "pallas_e2e": {...}, "pallas_e2e_strat": {...}, "device": "..."}

- ``value``: photons tracked through a whole step (census replays and
  fresh emission) per second of ``Simulation.step()``, the card
  synchronised at both ends of the timed steps;
- ``step_hbm_model_pct_of_peak``: the tracking rounds' bytes
  (``roofline.round_bytes`` of the run's configuration times its rounds)
  at the card's HBM rate (``roofline.PEAK_BYTES_S``), as a share of the
  measured time: how far the whole step is from the tracking's byte
  bound;
- ``mrk421_histories_per_s``: the same on ``mrk421(nst=20000,
  n_slots=1 << 16)``;
- ``pallas_e2e`` and ``pallas_e2e_strat``: ``e2e_gate.gate`` of the
  ``pair_corona`` and ``pair_corona_strat`` cells (the pair corona, and
  with stratified splitting) against the committed replicates of the
  reference's Pallas kernel, each with its recorded statistic and steps;
  ``passed``, ``rel_dev``, ``noise_floor`` and ``n_stiff_zones``, or
  ``{"passed": false, "error": ...}`` when the gate cannot run;
- ``device``: the card's name and power limit as ``nvidia-smi`` prints
  them.

The record also holds the timed steps, seconds and histories, the bytes
of a round, the flight kernel's launches of the main path by mode and
the tracker it ran (``Simulation.tracker``).
The same environment variables as ``bench.py`` choose the run:
``BENCH_SIZE`` (``small``, ``large`` or ``full``, the default),
``BENCH_STEPS`` (timed steps; 16, and 3 at ``small``), ``BENCH_TCONST``,
``BENCH_MAX_ITERS`` (``full``), ``BENCH_MRK421`` and
``BENCH_PALLAS_E2E`` (1 or 0; neither runs at ``small``). A summary
line goes to stderr::

  python -m compton2d_tpu_torch.bench
  BENCH_SIZE=small python -m compton2d_tpu_torch.bench --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from compton2d_tpu_torch import e2e_gate, roofline
from compton2d_tpu_torch.examples import mrk421, small_corona
from compton2d_tpu_torch.transport import flight

# small_corona's arguments at each size (bench.py's)
SIZES = {
    "small": dict(nz=4, nr=3, nst=5000, n_slots=1 << 14, num_nt=100,
                  n_vol=128, nphfield=128),
    # 32x32 = 1024 zones, the largest grid of the resident kernel modes
    "large": dict(nz=32, nr=32, nst=60000, n_slots=1 << 17, num_nt=200,
                  n_vol=400, nphfield=128),
    # reference-size tables: 200 gamma bins, 400-bin emissivity and field
    # grids (general.pa)
    "full": dict(nz=8, nr=4, nst=60000, n_slots=1 << 17, num_nt=200,
                 n_vol=400, nphfield=400),
}
WARM_STEPS = 2
MRK421 = dict(nst=20000, n_slots=1 << 16)
# record key -> gate cell
GATES = {"pallas_e2e": "pair_corona", "pallas_e2e_strat": "pair_corona_strat"}
GATE_KEYS = ("passed", "rel_dev", "noise_floor", "n_stiff_zones")


def settings(env=None) -> dict:
    """The run's settings from ``bench.py``'s environment variables."""
    env = os.environ if env is None else env
    size = env.get("BENCH_SIZE", "full")
    if size not in SIZES:
        raise ValueError(f"BENCH_SIZE={size!r}: not one of {sorted(SIZES)}")
    small = size == "small"
    return dict(
        size=size,
        steps=int(env.get("BENCH_STEPS", 3 if small else 16)),
        t_const=True if small else bool(int(env.get("BENCH_TCONST", 0))),
        max_iters=int(env.get("BENCH_MAX_ITERS", 256)),
        mrk421=bool(int(env.get("BENCH_MRK421", 1))) and not small,
        pallas_e2e=bool(int(env.get("BENCH_PALLAS_E2E", 1))) and not small,
    )


def build(s: dict, device="cuda"):
    kw = dict(SIZES[s["size"]], t_const=s["t_const"])
    if s["size"] == "full":
        kw["max_flight_iters"] = s["max_iters"]
    return small_corona(**kw, device=device)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure(sim, steps: int):
    """Seconds of ``steps`` steps (the card synchronised at both ends),
    the histories and the tracking rounds; the step outputs' counts stay
    on the device until the last step is done."""
    tracked, rounds = [], []
    _sync(sim.device)
    t0 = time.perf_counter()
    for _ in range(steps):
        out = sim.step()
        tracked.append(out.n_tracked)
        rounds.append(out.tallies.trk_rounds)
    _sync(sim.device)
    dt = time.perf_counter() - t0
    histories = int(torch.stack(tracked).to(torch.int64).sum())
    return dt, histories, int(torch.stack(rounds).to(torch.int64).sum())


def gate_record(cell: str, device="cuda") -> dict:
    """``bench.py``'s gate record of ``cell`` against the committed
    reference."""
    try:
        ref = e2e_gate.load_reference()[cell]
        sim = e2e_gate.build_cell(cell, ref["statistic"], device)
        bad = e2e_gate.check_config(sim, ref)
        if bad:
            raise ValueError(f"configuration differs from the reference's "
                             f"in {bad}")
        res = e2e_gate.gate(e2e_gate.port_replicates(sim, ref), ref)
    except (RuntimeError, ValueError, KeyError, OSError) as e:
        return {"passed": False, "error": f"{type(e).__name__}: {e}"}
    return {k: res[k] for k in GATE_KEYS}


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi prints them; "cpu"
    on the CPU."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def run(s: dict, device="cuda") -> dict:
    """The benchmark record of the settings ``s``."""
    sim = build(s, device)
    flight.reset_launch_counts()
    t0 = time.perf_counter()
    sim.step()
    _sync(device)
    first_s = time.perf_counter() - t0
    for _ in range(WARM_STEPS - 1):
        sim.step()
    dt, histories, rounds = measure(sim, s["steps"])
    rb = roofline.round_bytes(sim)
    bound_s = rounds * rb / roofline.PEAK_BYTES_S
    rec = {
        "metric": "photon_histories_per_sec_per_chip",
        "value": histories / dt,
        "unit": "histories/s",
        "step_hbm_model_pct_of_peak": 100.0 * bound_s / dt,
        "tracking_rounds_per_step": rounds / s["steps"],
        "size": s["size"], "steps": s["steps"], "measure_s": dt,
        "histories": histories, "rounds": rounds, "round_bytes": rb,
        "first_step_s": first_s, "flight_launches": flight.launch_counts(),
        "tracker": sim.tracker,
    }
    if s["mrk421"]:
        sim2 = mrk421(**MRK421, device=device)
        for _ in range(WARM_STEPS):
            sim2.step()
        mdt, mhist, _ = measure(sim2, s["steps"])
        rec["mrk421_histories_per_s"] = mhist / mdt
    if s["pallas_e2e"]:
        for key, cell in GATES.items():
            rec[key] = gate_record(cell, device)
    rec["device"] = card_line(device)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rec = run(settings(), args.device)
    print(json.dumps(rec), flush=True)
    print(f"# first step={rec['first_step_s']:.1f}s "
          f"measure={rec['measure_s']:.2f}s histories={rec['histories']} "
          f"device={rec['device']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
