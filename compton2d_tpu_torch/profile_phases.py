"""Per-phase time of the port's step on a CUDA card, from the program's
own telemetry (``compton2d_tpu_torch.telemetry``).

Runs a configuration twice from the same seed: first with telemetry off,
for the step time, then with it on, for the breakdown: each span's calls
and host and device ms a step (``step`` and its children ``step.census``,
``step.zone_pass``, ``step.source``, ``step.pairs``, ``step.track`` with
``track.tables``, ``track.flight``, ``track.leak`` and ``track.scatter``,
``step.fp`` and ``step.outputs``), each host-read site's reads and host
wait a step, the counts (FP substeps, tracking rounds, loop iterations)
and the kernels' launches. The card is synchronised only at the
ends of each run. Prints one JSON object::

  python -m compton2d_tpu_torch.profile_phases --config mrk421
  python -m compton2d_tpu_torch.profile_phases --config small_corona
  python -m compton2d_tpu_torch.profile_phases --config pair_corona
  python -m compton2d_tpu_torch.profile_phases --config large_corona
  python -m compton2d_tpu_torch.profile_phases --config disk_deck
  python -m compton2d_tpu_torch.profile_phases --config coulomb

``mrk421`` is the dense Mrk 421 run (10x4 zones, 131072 slots, nst
200000, n_e 2e6, stratified splitting with gamma_c 3e4 and 64 copies)
to t_stop; ``small_corona`` is the benchmark-size corona (8x4 zones,
131072 slots, nst 60000) and ``pair_corona`` the pair-producing corona of
``tools/pallas_e2e.py`` (4x3 zones, 262144 slots, nst 200000, amxwl 0.5,
gamma 3-20, pair_switch on), ``large_corona`` the corona on the
reference's largest grid (99x99 zones, 524288 slots, nst 240000, the main
path's table widths) and ``grid_40x30`` the reference's windowed-test grid
at the main path's widths and slots; ``disk_deck`` and ``ec_deck`` the
reference-format decks of ``compton2d_tpu_torch.decks`` loaded by the
legacy importer (8x4 zones with reflection, a flare and adaptive dt;
10x5 zones lit by a diskgen file), 131072 slots, nst 60000; ``coulomb`` the
benchmark-size corona with the Coulomb FP drift (``fp_include_coulomb``;
its tables are built before the runs, outside the times); each for 2
warm-up and ``--steps`` timed steps. Beside them it prints the
tracking rounds, the lower and outer-disk reflections, the lanes frozen
with FLAG_WINDOW and the stragglers sent to census per step, and the
card's peak memory.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from compton2d_tpu_torch import decks, run_mrk421
from compton2d_tpu_torch import telemetry as tm
from compton2d_tpu_torch.bench import card_line
from compton2d_tpu_torch.examples import small_corona
from compton2d_tpu_torch.fp import update
from compton2d_tpu_torch.physics import emissivity
from compton2d_tpu_torch.transport import flight


def make_sim(config: str, device):
    if config == "mrk421":
        args = run_mrk421.parser().parse_args(
            ["--nst", "200000", "--n-slots", "131072", "--n-e", "2e6",
             "--strat-gamma-c", "3e4", "--strat-copies", "64",
             "--device", str(device)])
        return run_mrk421.make_sim(args)
    if config in decks.WRITERS:
        return decks.deck_sim(config, device)
    if config == "pair_corona":
        return small_corona(nz=4, nr=3, nst=200000, n_slots=1 << 18,
                            num_nt=100, n_vol=128, nphfield=128,
                            t_const=False, pair_switch=1, amxwl=0.5,
                            gmin=3.0, gmax=20.0, device=device)
    # (nz, nr, nst, n_slots) of the coronae at the main path's widths
    nz, nr, nst, n_slots = {
        "large_corona": (99, 99, 240000, 1 << 19),
        "grid_40x30": (40, 30, 60000, 1 << 17),
    }.get(config, (8, 4, 60000, 1 << 17))
    return small_corona(nz=nz, nr=nr, nst=nst, n_slots=n_slots, num_nt=200,
                        n_vol=400, nphfield=400, t_const=False,
                        max_flight_iters=256, device=device,
                        fp_include_coulomb=config == "coulomb")


def drive(sim, config: str, steps: int, warm: int, on_timed=None):
    """Step the sim; returns (seconds, outputs) of the timed steps, and
    calls ``on_timed`` between the warm-up and the timed steps."""
    if config == "mrk421":
        warm, steps = 0, 1_000_000    # to t_stop
    for _ in range(warm):
        sim.step()
    if on_timed is not None:
        on_timed()
    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        sim._sync_clock()
        if (config == "mrk421" and sim._host_time - sim._host_dt_prev
                >= sim.cfg.run.t_stop):
            break
        outs.append(sim.step())
    torch.cuda.synchronize()
    return time.perf_counter() - t0, outs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config",
                    choices=("mrk421", "small_corona", "pair_corona",
                             "large_corona", "grid_40x30", "disk_deck",
                             "ec_deck", "coulomb"),
                    default="mrk421")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--warm", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_phases: needs a CUDA card")
    device = torch.device("cuda", 0)
    flight.build()
    update.build()
    emissivity.build()

    sim = make_sim(args.config, device)
    torch.cuda.reset_peak_memory_stats(device)
    wall, outs = drive(sim, args.config, args.steps, args.warm)
    n = len(outs)
    peak = torch.cuda.max_memory_allocated(device)

    tm.reset()
    try:
        wall_t, outs_t = drive(make_sim(args.config, device), args.config,
                               args.steps, args.warm, on_timed=tm.enable)
    finally:
        tm.disable()
    snap = tm.snapshot()
    tm.reset()
    n_t = len(outs_t)
    card = card_line(device)
    print(json.dumps({
        "config": args.config, "card": card, "steps": n,
        "ms_per_step": 1e3 * wall / n,
        "histories_per_s": sum(int(o.n_tracked) for o in outs) / wall,
        "rounds_per_step": sum(int(o.tallies.trk_rounds) for o in outs) / n,
        "fp_substeps_per_step": sum(int(o.fp_substeps) for o in outs) / n,
        "reflections_lower_per_step":
            sum(int(o.tallies.n_reflect_lower) for o in outs) / n,
        "reflections_disk_per_step":
            sum(int(o.tallies.n_reflect_disk) for o in outs) / n,
        "window_freezes_per_step":
            sum(int(o.tallies.n_window) for o in outs) / n,
        "stragglers_per_step":
            sum(int(o.tallies.n_straggler) for o in outs) / n,
        "peak_memory_bytes": peak,
        "ms_per_step_telemetry": 1e3 * wall_t / n_t,
        "spans_per_step": {
            k: {"calls": v["calls"] / n_t, "host_ms": v["host_ms"] / n_t,
                "device_ms": (None if v["device_ms"] is None
                              else v["device_ms"] / n_t)}
            for k, v in snap["spans"].items()},
        "reads_per_step": {k: {"count": v["count"] / n_t,
                               "wait_ms": v["wait_ms"] / n_t}
                           for k, v in snap["reads"].items()},
        "counts_per_step": {k: v / n_t for k, v in snap["counts"].items()},
        "launches": snap["launches"],
    }))


if __name__ == "__main__":
    main()
