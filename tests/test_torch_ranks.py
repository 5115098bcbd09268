"""Rank programs of tests/test_torch_parallel.py; this file holds no
test. Each runs in a process of its own, started by
``compton2d_tpu_torch.parallel.distributed.run_ranks`` with the rank's
mesh as its first argument, and returns numpy results. A spawned rank
imports the module of its program by name, so the programs live apart
from the test file, which imports jax and the JAX package: here nothing
does."""
import dataclasses
import os

import numpy as np
import torch

from compton2d_tpu_torch.driver import Simulation
from compton2d_tpu_torch.examples import small_corona
from compton2d_tpu_torch.io import checkpoint
from compton2d_tpu_torch.parallel import mesh as pmesh

# the JAX package's _tiny corona (tests/test_driver.py:11-15); the port's
# ranks need whole 1024-slot tiles, so 4 ranks take 4096 slots
TINY = dict(nz=3, nr=2, nst=500, num_nt=50, n_vol=48, nphfield=48)


def tallies_np(out) -> dict:
    return {f: getattr(out.tallies, f).numpy().copy()
            for f in out.tallies._fields}


def state_np(state) -> dict:
    """Every tensor of a SimState (and its generator's state) as numpy."""
    out = {"key": state.key.get_state().numpy().copy()}
    for name in state._fields:
        leaf = getattr(state, name)
        if hasattr(leaf, "_fields"):
            out.update({f"{name}.{f}": getattr(leaf, f).numpy().copy()
                        for f in leaf._fields})
        elif isinstance(leaf, torch.Tensor):
            out[name] = leaf.numpy().copy()
    return out


def differing(a: dict, b: dict) -> list:
    return [k for k in a if not np.array_equal(a[k], b[k])]


def _with_run(sim, **run):
    return sim.with_config(dataclasses.replace(
        sim.cfg, run=dataclasses.replace(sim.cfg.run, **run)))


def conserve(mesh, n_slots: int, steps: int, seed: int = 0) -> dict:
    sim = small_corona(**TINY, n_slots=n_slots, t_const=True, seed=seed,
                       device="cpu", mesh=mesh)
    balance, tallies = [], []
    for _ in range(steps):
        out = sim.step()
        balance.append(sim.energy_audit()["balance"])
        tallies.append(tallies_np(out))
    return dict(balance=balance, tallies=tallies,
                alive=int(sim.state.photons.alive.sum()),
                slots=sim.state.photons.n_slots,
                zones={f: getattr(sim.state.zones, f).numpy().copy()
                       for f in sim.state.zones._fields},
                comm_calls=mesh.comm_calls)


def self_determinism(mesh, n_slots: int, seed: int) -> dict:
    a = conserve(mesh, n_slots, 1, seed)
    b = conserve(mesh, n_slots, 1, seed)
    return dict(first=a["tallies"][0], second=b["tallies"][0])


def zone_shard(mesh, injection: dict, steps: int) -> dict:
    """The JAX test's pair corona with the zone farm on and off."""
    from compton2d_tpu_torch.config import InjectionConfig

    kw = dict(injection=InjectionConfig(**injection)) if injection else {}
    base = small_corona(nz=3, nr=2, nst=1000, n_slots=4096, num_nt=40,
                        n_vol=48, nphfield=48, t_const=False, seed=11,
                        device="cpu", mesh=mesh, pair_switch=True, **kw)
    runs = {}
    for flag in (False, True):
        sim = _with_run(base, zone_shard=flag)
        outs = [sim.step() for _ in range(steps)]
        runs[flag] = dict(
            e_el=[(float(o.e_el_old), float(o.e_el_new)) for o in outs],
            substeps=[int(o.fp_substeps) for o in outs],
            tallies=[tallies_np(o) for o in outs],
            zones={f: getattr(sim.state.zones, f).numpy().copy()
                   for f in sim.state.zones._fields})
    return runs


def event_flush(mesh, out_dir: str) -> dict:
    sim = small_corona(**TINY, n_slots=2048, t_const=True, seed=0,
                       device="cpu", mesh=mesh)
    sim.attach_outputs(out_dir)
    counts = [int(sim.step().events.count.sum()) for _ in range(2)]
    w = sim.event_writer
    return dict(path=w.path, counts=counts, written=w.n_written,
                dropped=w.n_dropped, outputs=sim.outputs is not None)


def one_rank(mesh, steps: int) -> dict:
    """The same corona with a one-rank mesh and with none."""
    sims = [small_corona(**TINY, n_slots=2048, t_const=False, seed=4,
                         device="cpu", mesh=m) for m in (mesh, None)]
    bad = []
    for i in range(steps):
        a, b = (s.step() for s in sims)
        bad += [f"step {i} {f}" for f in differing(tallies_np(a),
                                                   tallies_np(b))]
    bad += differing(state_np(sims[0].state), state_np(sims[1].state))
    return dict(differing=bad, comm_calls=mesh.comm_calls)


def resume(mesh, out_dir: str, first_steps: int, more_steps: int) -> dict:
    """first_steps, then run_to_stop with the walltime guard tripped on the
    last rank only, then a fresh Simulation resumed from the checkpoint for
    more_steps, against an uninterrupted run of both."""
    kw = dict(TINY, n_slots=2048, t_const=False, seed=9, device="cpu")
    first = _with_run(small_corona(**kw, mesh=mesh), t_stop=1e30)
    first.attach_outputs(os.path.join(out_dir, "cut"))
    outs = [first.step() for _ in range(first_steps)]
    ck = os.path.join(out_dir, "ck", "state.npz")
    budget = 1e-9 if mesh.rank == mesh.world - 1 else 0.0
    completed = first.run_to_stop(walltime_budget_s=budget,
                                  checkpoint_path=ck)
    resumed = Simulation(first.cfg, first.zone_init, device="cpu", mesh=mesh)
    resumed.attach_outputs(os.path.join(out_dir, "cut"), resume=True)
    resumed.state = checkpoint.load_checkpoint(ck, resumed.state, mesh=mesh)
    outs += [resumed.step() for _ in range(more_steps)]
    whole = _with_run(small_corona(**kw, mesh=mesh), t_stop=1e30)
    whole.attach_outputs(os.path.join(out_dir, "whole"))
    ref = [whole.step() for _ in range(first_steps + more_steps)]
    bad = []
    for i, (a, b) in enumerate(zip(outs, ref)):
        bad += [f"step {i} {f}" for f in differing(tallies_np(a),
                                                   tallies_np(b))]
        if not torch.equal(a.events.data, b.events.data):
            bad.append(f"step {i} events")
    bad += differing(state_np(resumed.state), state_np(whole.state))
    # a single-process checkpoint does not load under this mesh
    single = os.path.join(out_dir, f"single{mesh.rank}.npz")
    checkpoint.save_checkpoint(single, whole.state)
    try:
        checkpoint.load_checkpoint(single, whole.state, mesh=mesh)
        refused = ""
    except ValueError as e:
        refused = str(e)
    return dict(completed=completed, differing=bad, checkpoint=ck,
                events=(first.event_writer.path, whole.event_writer.path),
                refused=refused, ncycle=int(first.state.ncycle))


def exchange(mesh, n_zones: int) -> dict:
    """Each reduction of parallel.mesh on data made from the rank."""
    rng = np.random.default_rng(mesh.rank)
    f = torch.as_tensor(rng.standard_normal(5).astype(np.float32) * 1e3)
    i = torch.as_tensor(rng.integers(-100, 100, 3, dtype=np.int32))
    s_f, s_i = pmesh.all_gather_sum(mesh, (f, i))
    zones = torch.arange(n_zones * 2, dtype=torch.float32).reshape(
        n_zones, 1, 2) + 0.5
    part = pmesh.zone_slice(mesh, zones)
    valid = pmesh.zone_valid(mesh, n_zones, "cpu")
    back, mx, mn = pmesh.zone_gather(
        mesh, part * 2.0, n_zones, 1,
        extra=[(f, pmesh.MAX), (f, pmesh.MIN)])
    return dict(f=f.numpy(), i=i.numpy(), sum_f=s_f.numpy(),
                sum_i=s_i.numpy(), max=mx.numpy(), min=mn.numpy(),
                part=part.numpy(), valid=valid.numpy(), back=back.numpy(),
                zones=zones.numpy())


def observables(mesh, seeds, steps: int, cfg: dict) -> list:
    """escaped, census and mean Te after ``steps`` for each seed."""
    out = []
    for s in seeds:
        sim = small_corona(**cfg, seed=s, device="cpu", mesh=mesh)
        sim.run(steps)
        a = sim.energy_audit()
        out.append([a["escaped"], a["census"],
                    float(sim.state.zones.tea.mean())])
    return out


def loop_steps(mesh, n_slots: int, steps: int) -> dict:
    """The tiny corona with the FP solve on, ``pallas_tracking`` "auto",
    ``n_slots`` split over the ranks: the tracker, each step's balance and
    tallies, and the zones."""
    sim = small_corona(**TINY, n_slots=n_slots, t_const=False, seed=5,
                       device="cpu", mesh=mesh)
    balance, tallies = [], []
    for _ in range(steps):
        out = sim.step()
        balance.append(sim.energy_audit()["balance"])
        tallies.append(tallies_np(out))
    return dict(tracker=sim.tracker, balance=balance, tallies=tallies,
                slots=sim.state.photons.n_slots,
                zones={f: getattr(sim.state.zones, f).numpy().copy()
                       for f in sim.state.zones._fields})
