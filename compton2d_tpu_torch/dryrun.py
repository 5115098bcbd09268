"""Entry points for checking a whole step (counterpart of the repository
root's ``__graft_entry__.py``).

- :func:`entry` -> ``(fn, example_args)``: one step of the tiny corona as
  a plain function of its state and statics (eager PyTorch; nothing is
  compiled).
- :func:`dryrun_multichip` runs the full step with pair physics and the
  Coulomb Fokker-Planck terms on ``world`` ranks at bench widths, with an
  event buffer too small for the step's escapes (the records past it are
  counted per rank) and the census roulette's thresholds lowered so that
  it fires, and holds it against one rank of the same global photon
  count; then the 1-vs-N test over seed replicates at the tiny shapes.

Two ranks on one card share it under ``gloo`` (NCCL refuses two ranks on
one device)::

    python -m compton2d_tpu_torch.dryrun --world 2
    python -m compton2d_tpu_torch.dryrun --world 2 --device cpu --tiny
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from compton2d_tpu_torch import driver
from compton2d_tpu_torch.config import ZoneInit
from compton2d_tpu_torch.driver import Simulation
from compton2d_tpu_torch.examples import corona_config
from compton2d_tpu_torch.fp import update
from compton2d_tpu_torch.parallel import distributed
from compton2d_tpu_torch.physics import emissivity
from compton2d_tpu_torch.transport import flight

# the JAX entry's shapes: the tiny corona (1024 slots a rank: the port's
# ranks hold whole kernel tiles) and the bench widths (the 8x4 grid,
# 200 gamma x 400 emissivity and field bins, 32768 slots a rank)
TINY = dict(nz=3, nr=2, nst=512, num_nt=40, n_vol=32, nphfield=32)
BENCH = dict(nz=8, nr=4, nst=60000, num_nt=200, n_vol=400, nphfield=400)
SLOTS_TINY, SLOTS_BENCH = 1024, 1 << 15
STEPS = 3
# deliberately undersized: most escape records of a step are dropped
# (and counted); the roulette's thresholds are lowered so that it fires
EVENT_CAPACITY = 64
CENSUS_RR_HI, CENSUS_RR_LO = 0.05, 0.03
BINGO_RTOL, AUDIT_TOL = 1e-6, 5e-3
CENSUS_RATIO = (0.5, 2.0)
# the 1-vs-N test: seed replicates a side, steps a replicate, z bound
Z_SEEDS, Z_MAX = 5, 4.0
Z_CHANNELS = ("census", "escaped", "edep")
RANKS_TIMEOUT_S, INIT_TIMEOUT_S = 900.0, 120.0


def _config(world: int, tiny: bool, seed: int = 0, **phys_kw):
    kw = TINY if tiny else BENCH
    slots = SLOTS_TINY if tiny else SLOTS_BENCH
    return corona_config(**kw, n_slots=slots * world, seed=seed, **phys_kw)


def entry(device="cuda"):
    """One main-path step of the tiny corona, ``fn(state, src, grid,
    tables) -> (state, outputs)``, and its arguments."""
    cfg, zi = _config(1, tiny=True)
    sim = Simulation(cfg, zi, device=device)

    def fn(state, src, grid, tables):
        const = driver.step_constants(cfg, grid, tables, sim.scales,
                                      sim.tracker, 1, sim.pair_tables,
                                      sim.coulomb_tables)
        return driver._step_impl(state, src, int(state.ncycle), None, const)

    return fn, (sim.state, sim.src_static, sim.grid, sim.tables)


def dryrun_config(world: int, tiny: bool = False):
    """The dry run's configuration and zones: pairs and Coulomb on, the
    undersized event buffer, the lowered roulette thresholds."""
    cfg, _ = _config(world, tiny, pair_switch=1, fp_include_coulomb=True)
    cfg = dataclasses.replace(cfg, run=dataclasses.replace(
        cfg.run, event_capacity=EVENT_CAPACITY, census_rr_hi=CENSUS_RR_HI,
        census_rr_lo=CENSUS_RR_LO))
    zi = ZoneInit.uniform(cfg.grid, tea=100.0, tna=100.0, n_e=1e10,
                          B_field=10.0)
    return cfg, zi


def _run(sim: Simulation, steps: int = STEPS) -> dict:
    """``steps`` steps: each step's energy budget (bingo), audit balance and
    event count, the roulette's rolled photons, the records dropped, and
    the census energy of the last step."""
    bingos, balances, counts, n_rr = [], [], [], 0
    for _ in range(steps):
        out = sim.step()
        a = sim.energy_audit()
        bingos.append(float(out.bingo))
        balances.append(a["balance"])
        counts.append(int(out.events.count.sum()))
        n_rr += int(out.tallies.n_rr)
    return dict(bingos=bingos, balances=balances, event_counts=counts,
                n_rr=n_rr, events_dropped=int(sim.energy_audit()[
                    "events_dropped"]),
                capacity=int(out.events.data.shape[0]),
                census=float(out.tallies.ecens.sum()),
                slots=sim.state.photons.n_slots, tracker=sim.tracker)


def _z_channels(out) -> dict:
    t = out.tallies
    return {"census": float(t.ecens.sum()),
            "escaped": float(t.erlk_inner.sum() + t.erlk_outer.sum()
                             + t.erlk_upper.sum() + t.erlk_lower.sum()),
            "edep": float(t.edep.abs().sum())}


def _replicates(world: int, seeds, device, mesh=None) -> dict:
    """The channels of each seed's replicate: STEPS steps of the tiny pair
    corona at ``world`` ranks' global slots (on ``mesh``, or one rank)."""
    reps = {q: [] for q in Z_CHANNELS}
    for s in seeds:
        cfg, zi = _config(world, tiny=True, seed=s, pair_switch=1)
        sim = Simulation(cfg, zi, device=device, mesh=mesh)
        for _ in range(STEPS):
            out = sim.step()
        for q, v in _z_channels(out).items():
            reps[q].append(v)
    return reps


def z_seeds(side: str):
    """The seeds of the N-rank and the 1-rank side (``__graft_entry__``'s)."""
    base = 7 if side == "n" else 1000
    return [base + 31 * i for i in range(Z_SEEDS)]


def _rank(mesh, tiny: bool) -> dict:
    """One rank's part: the dry run's steps and the N-rank z replicates,
    with the flight kernel's launches of both."""
    device = mesh.device
    if device.type == "cuda":
        torch.cuda.set_device(device)
    cfg, zi = dryrun_config(mesh.world, tiny)
    t0 = time.perf_counter()
    sim = Simulation(cfg, zi, device=device, mesh=mesh)
    build_s = time.perf_counter() - t0
    flight.reset_launch_counts()
    res = _run(sim)
    res["z"] = _replicates(mesh.world, z_seeds("n"), device, mesh)
    res.update(build_s=build_s, rank=mesh.rank,
               launches=flight.launch_counts())
    return res


def z_test(a: dict, b: dict) -> dict:
    """z = |mean_a - mean_b| / sqrt(var_a / K + var_b / K) per channel."""
    zs = {}
    for q in Z_CHANNELS:
        x, y = np.asarray(a[q], np.float64), np.asarray(b[q], np.float64)
        se = np.sqrt(x.var(ddof=1) / len(x) + y.var(ddof=1) / len(y))
        zs[q] = float(abs(x.mean() - y.mean()) / max(se, 1e-300))
    return zs


def dryrun_multichip(world: int, device="cuda", backend: str = "gloo",
                     tiny: bool = False,
                     rendezvous_dir: Optional[str] = None,
                     threads: Optional[int] = None) -> dict:
    """The dry run on ``world`` ranks (spawned processes; ``device`` for
    every rank, ``"cuda"`` meaning cuda:0 shared by all, or None for a
    card a rank) against one rank (this process, on ``device``, cuda:0
    when it is None) of the same global photon count. Raises
    AssertionError when a check fails:
    the first step's energy budget equal to rtol 1e-6, the roulette fired
    on both sides, every audit within 5e-3, the census energies within
    0.5x-2x, one event count a rank and each rank's dropped records
    counted, and the 1-vs-N z-test below 4 on census, escaped and
    deposited energy (5 seeds a side at the tiny shapes). Returns the
    readings."""
    local = torch.device("cuda" if device is None else device)
    if local.type == "cuda":
        if local.index is None:
            local = torch.device("cuda", 0)
        # the ranks only load the kernel libraries: build them once, here
        flight.build()
        update.build()
        emissivity.build()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=rendezvous_dir) as tmp:
        ranks = distributed.run_ranks(
            _rank, world, (tiny,), backend=backend,
            device=None if device is None else local, rendezvous_dir=tmp,
            timeout_s=RANKS_TIMEOUT_S, init_timeout_s=INIT_TIMEOUT_S,
            threads=threads)
    ranks_s = time.perf_counter() - t0
    cfg, zi = dryrun_config(world, tiny)
    t1 = time.perf_counter()
    one = _run(Simulation(cfg, zi, device=local))
    one_s = time.perf_counter() - t1
    r0 = ranks[0]

    if not np.isclose(r0["bingos"][0], one["bingos"][0], rtol=BINGO_RTOL):
        raise AssertionError(f"first-step energy budget: {world} ranks "
                             f"{r0['bingos']}, 1 rank {one['bingos']}")
    if not (r0["n_rr"] > 0 and one["n_rr"] > 0):
        raise AssertionError(f"census roulette did not fire: {world} ranks "
                             f"{r0['n_rr']}, 1 rank {one['n_rr']}")
    for b in [b for r in ranks for b in r["balances"]] + one["balances"]:
        if not abs(b - 1.0) < AUDIT_TOL:
            raise AssertionError(f"audit: ranks "
                                 f"{[r['balances'] for r in ranks]}, 1 rank "
                                 f"{one['balances']}")
    tot, tot1 = r0["census"], one["census"]
    if not (np.isfinite(tot) and np.isfinite(tot1)):
        raise AssertionError(f"census energy {tot}, 1 rank {tot1}")
    if tot1 > 0 and not (CENSUS_RATIO[0] < (tot + 1e-30) / tot1
                         < CENSUS_RATIO[1]):
        raise AssertionError(f"census energy {tot} against 1 rank's {tot1}")
    counts = [r["event_counts"] for r in ranks]
    if len(counts) != world or any(len(c) != STEPS for c in counts):
        raise AssertionError(f"event counts {counts}")
    for r in ranks + [one]:
        # records past the buffer are counted, not lost silently
        want = sum(max(c - r["capacity"], 0) for c in r["event_counts"])
        if r["events_dropped"] != want:
            raise AssertionError(f"dropped records {r['events_dropped']} "
                                 f"against counts {r['event_counts']}")
    if any(r["bingos"] != r0["bingos"] or r["n_rr"] != r0["n_rr"]
           or r["census"] != r0["census"] for r in ranks):
        raise AssertionError("reduced tallies differ across the ranks")

    b = _replicates(world, z_seeds("1"), local)
    zs = z_test(r0["z"], b)
    if not all(z < Z_MAX for z in zs.values()):
        raise AssertionError(f"1-vs-{world}-rank z-test: {zs}")
    g = cfg.grid
    return dict(
        world=world, backend=backend, tiny=tiny,
        shapes=dict(nz=g.nz, nr=g.nr, num_nt=g.num_nt, n_vol=g.n_vol,
                    nphfield=g.nphfield, slots_per_rank=r0["slots"],
                    nst=cfg.source.nst),
        bingo=r0["bingos"][0], bingo_one_rank=one["bingos"][0],
        balances=r0["balances"], balances_one_rank=one["balances"],
        n_rr=r0["n_rr"], n_rr_one_rank=one["n_rr"],
        census=tot, census_one_rank=tot1,
        event_counts=counts, events_dropped=[r["events_dropped"]
                                             for r in ranks],
        event_counts_one_rank=one["event_counts"],
        events_dropped_one_rank=one["events_dropped"],
        capacity=EVENT_CAPACITY, launches=[r["launches"] for r in ranks],
        trackers=[r["tracker"] for r in ranks] + [one["tracker"]],
        build_s=[r["build_s"] for r in ranks], ranks_s=ranks_s,
        one_rank_s=one_s, z=zs, z_seeds=Z_SEEDS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--tiny", action="store_true",
                    help="the dry run's steps at the tiny shapes too")
    args = ap.parse_args(argv)
    fn, example = entry(args.device)
    fn(*example)
    print("entry(): ran one step", flush=True)
    print(json.dumps(dryrun_multichip(args.world, args.device, args.backend,
                                      args.tiny)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
