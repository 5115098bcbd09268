"""Per-phase time of the port's step on a CUDA card.

Runs a configuration twice from the same seed: first plain, for the step
time, then with every phase of the step wrapped in a timer that
synchronises the card before and after it, for the breakdown (inclusive
times: ``transport_step`` contains the flight kernel, ``_leak`` and
``apply_scatter``; ``apply_scatter`` contains its ``scatter_stratified``
sampler calls; ``pair_fields``, the pair physics of the census field,
contains its ``hist2d``, ``nph_smooth``, ``dn_pp_from_field`` and
``pa_rates``; ``zone_sort`` runs on grids above 1024 zones). Prints one
JSON object::

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
warm-up and ``--steps`` timed steps. Beside the times it prints the
tracking rounds, the lower and outer-disk reflections, the lanes
frozen with FLAG_WINDOW and the stragglers sent to census per step, the
card's peak memory, and the flight kernel's own device time per step
(CUDA events around each launch in the plain run, read after it).
"""
from __future__ import annotations

import argparse
import collections
import json
import time

import torch

from compton2d_tpu_torch import decks, driver, run_mrk421
from compton2d_tpu_torch.bench import card_line
from compton2d_tpu_torch.examples import small_corona
from compton2d_tpu_torch.physics import pairs
from compton2d_tpu_torch.transport import flight, tracking

# (module, attribute) of each timed phase, as the step looks them up
PHASES = (
    (driver, "equipartition_b"), (driver, "volume_em"),
    (driver.sourcing, "compute_budget"), (driver, "census_roulette"),
    (driver, "zone_sort"),
    (driver.sourcing, "emit"), (driver, "zone_sigma_table"),
    (driver, "transport_step"), (flight, "flight_step"),
    (tracking, "_leak"), (tracking, "apply_scatter"),
    (tracking, "scatter_stratified"), (tracking, "segment_sum"),
    (driver, "census_tally"), (driver, "fp_step"),
    (driver, "pair_fields"), (driver, "hist2d"), (pairs, "nph_smooth"),
    (pairs, "dn_pp_from_field"), (pairs, "pa_rates"),
)


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

    sim = make_sim(args.config, device)
    torch.cuda.reset_peak_memory_stats(device)
    events = []
    launch = flight._launch

    def launch_timed(largs):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        launch(largs)
        t1.record()
        events.append((t0, t1))

    flight._launch = launch_timed
    try:
        wall, outs = drive(sim, args.config, args.steps, args.warm,
                           on_timed=events.clear)
    finally:
        flight._launch = launch
    n = len(outs)
    peak = torch.cuda.max_memory_allocated(device)
    kernel_ms = sum(t0.elapsed_time(t1) for t0, t1 in events)

    acc = collections.defaultdict(lambda: [0.0, 0])
    originals = []

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            acc[name][0] += time.perf_counter() - t0
            acc[name][1] += 1
            return out
        return wrapper

    for mod, name in PHASES:
        originals.append((mod, name, getattr(mod, name)))
        setattr(mod, name, timed(name, getattr(mod, name)))
    try:
        wall_w, outs_w = drive(make_sim(args.config, device), args.config,
                               args.steps, args.warm, on_timed=acc.clear)
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
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
        "flight_kernel_device_ms_per_step": kernel_ms / n,
        "flight_launches_per_step": len(events) / n,
        "ms_per_step_wrapped": 1e3 * wall_w / len(outs_w),
        "phases_ms_per_step": {k: 1e3 * v[0] / len(outs_w)
                               for k, v in acc.items()},
        "calls_per_step": {k: v[1] / len(outs_w) for k, v in acc.items()},
    }))


if __name__ == "__main__":
    main()
