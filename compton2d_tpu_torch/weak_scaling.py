"""Weak scaling: fixed photon work a rank, 1 -> N ranks (the counterpart
of ``tools/weak_scaling.py``).

Each world size runs the sharded corona through
``parallel.distributed.run_ranks`` with SLOTS_PER_RANK slots and
NST_PER_RANK photons a step on every rank, and reports the step time,
the histories per second and the time in collectives; the efficiency of
N ranks is the 1-rank step time over the N-rank one. The backend is
``gloo`` on the CPU and for ranks sharing one card, ``nccl`` where each
rank has a card of its own::

  python -m compton2d_tpu_torch.weak_scaling --worlds 1 2 --device cpu
  python -m compton2d_tpu_torch.weak_scaling --worlds 1 2 4   # 4 cards
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time

import torch

from compton2d_tpu_torch.examples import small_corona
from compton2d_tpu_torch.parallel import distributed

SHAPE = dict(nz=8, nr=4, num_nt=200, n_vol=400, nphfield=400,
             t_const=False)
SLOTS_PER_RANK, NST_PER_RANK = 1 << 17, 60000
WARM, STEPS = 2, 4


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def rank_run(mesh, shape: dict, slots: int, nst: int, warm: int,
             steps: int) -> dict:
    """One rank: ``warm`` + ``steps`` steps of the sharded corona."""
    sim = small_corona(**shape, n_slots=slots * mesh.world,
                       nst=nst * mesh.world, device=mesh.device, mesh=mesh)
    for _ in range(warm):
        sim.step()
    _sync(mesh.device)
    comm0 = mesh.comm_s
    t0 = time.perf_counter()
    hist = 0
    for _ in range(steps):
        out = sim.step()
        hist += int(out.n_tracked)
    _sync(mesh.device)
    dt = (time.perf_counter() - t0) / steps
    return {"step_s": dt, "histories_per_s": hist / (dt * steps),
            "comm_s_per_step": (mesh.comm_s - comm0) / steps,
            "balance": sim.energy_audit()["balance"]}


def backend_for(world: int, device: str) -> tuple:
    """(backend, device of run_ranks) for ``world`` ranks on ``device``
    ("cpu" or "cuda")."""
    if device == "cpu":
        return "gloo", "cpu"
    if torch.cuda.device_count() >= world:
        return "nccl", None
    return "gloo", torch.device("cuda", 0)


def run(worlds=(1, 2), device: str = "cuda", shape: dict = SHAPE,
        slots: int = SLOTS_PER_RANK, nst: int = NST_PER_RANK,
        warm: int = WARM, steps: int = STEPS, threads=None) -> dict:
    rows = []
    for world in worlds:
        backend, dev = backend_for(world, device)
        with tempfile.TemporaryDirectory() as tmp:
            res = distributed.run_ranks(
                rank_run, world, (shape, slots, nst, warm, steps),
                backend=backend, device=dev, rendezvous_dir=tmp,
                timeout_s=1800.0, threads=threads)
        step_s = max(r["step_s"] for r in res)
        rows.append({
            "ranks": world, "backend": backend,
            "slots_per_rank": slots, "nst_per_rank": nst,
            "step_s": step_s,
            "histories_per_s": res[0]["histories_per_s"],
            "comm_s_per_step": [r["comm_s_per_step"] for r in res],
            "balance": res[0]["balance"],
        })
    base = rows[0]["step_s"]
    for r in rows:
        r["efficiency"] = base / r["step_s"]
    return {"device": device, "rows": rows}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worlds", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args()
    print(json.dumps(run(args.worlds, args.device, steps=args.steps),
                     indent=1))


if __name__ == "__main__":
    main()
