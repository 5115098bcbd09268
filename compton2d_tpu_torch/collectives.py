"""The bytes each rank sends in the collectives of a sharded step (the
counterpart of ``tools/collectives.py``).

The JAX tool reads its census from the compiled HLO; the port's every
cross-rank reduction is one ``parallel.mesh.exchange`` (one all_gather of
one flat buffer), so the census is the list of the buffers' bytes that
each step sends (``PhotonMesh.exchange_sizes``). The property checked is
the tool's: every reduction is O(zones x bins) (tallies summed, the zone
farm's slices gathered) and independent of the photon count, so the
bytes of a step are the same at any photon load::

  python -m compton2d_tpu_torch.collectives --world 2 --device cpu
  python -m compton2d_tpu_torch.collectives --world 2   # ranks on cuda:0

The ranks run the main path's corona (8x4 zones, 200 x 400 tables) with
pair physics and the zone farm on, as the JAX tool's census does, at
LOADS times a base of slots and photons a rank.
"""
from __future__ import annotations

import argparse
import json
import tempfile

import torch

from compton2d_tpu_torch.examples import small_corona
from compton2d_tpu_torch.parallel import distributed

SHAPE = dict(nz=8, nr=4, num_nt=200, n_vol=400, nphfield=400,
             t_const=False, pair_switch=True)
LOADS = (1, 2)
SLOTS_PER_RANK, NST_PER_RANK = 1 << 14, 2000


def step_exchanges(sim, steps: int) -> tuple:
    """Run ``steps`` steps of a sharded ``sim``: (their outputs, the bytes
    of each exchange of each step)."""
    mesh = sim.mesh
    outs, sizes = [], []
    try:
        for _ in range(steps):
            mesh.exchange_sizes = []
            outs.append(sim.step())
            sizes.append(mesh.exchange_sizes)
    finally:
        mesh.exchange_sizes = None
    return outs, sizes


def summary(sizes: list) -> dict:
    """Exchanges and bytes a step, and whether every step sent the same."""
    return {"exchanges_per_step": [len(s) for s in sizes],
            "bytes_per_step": [sum(s) for s in sizes],
            "sizes": sizes[-1],
            "steps_equal": all(s == sizes[0] for s in sizes)}


def rank_census(mesh, shape: dict, loads, slots: int, nst: int,
                steps: int) -> dict:
    """On one rank: the exchange census of ``steps`` steps at each load
    (slots and photons a rank times the load)."""
    out = {}
    for load in loads:
        sim = small_corona(**shape, n_slots=slots * load * mesh.world,
                           nst=nst * load * mesh.world, device=mesh.device,
                           mesh=mesh)
        out[load] = step_exchanges(sim, steps)[1]
    return out


def run(world: int = 2, device="cuda", backend: str = "gloo",
        steps: int = 2, shape: dict = SHAPE, loads=LOADS,
        slots: int = SLOTS_PER_RANK, nst: int = NST_PER_RANK,
        threads=None) -> dict:
    """The census on ``world`` ranks (``run_ranks``); ``constant`` says
    whether each step sent the same bytes at every load, on every rank.
    ``device="cuda"`` puts every rank on cuda:0 under gloo, and each rank
    on a card of its own under nccl."""
    rank_dev = device
    if str(device) == "cuda":
        rank_dev = None if backend == "nccl" else torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        res = distributed.run_ranks(
            rank_census, world, (shape, loads, slots, nst, steps),
            backend=backend, device=rank_dev, rendezvous_dir=tmp,
            timeout_s=900.0, threads=threads)
    per_load = {load: summary(res[0][load]) for load in loads}
    constant = all(r[load] == res[0][loads[0]] for r in res for load in loads)
    return {"world": world, "backend": backend, "device": str(device),
            "slots_per_rank": [slots * load for load in loads],
            "nst": [nst * load * world for load in loads],
            "per_load": per_load,
            "photon_soa_bytes_never_sent": [
                slots * load * 12 * 4 for load in loads],
            "constant": constant}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="gloo",
                    help="gloo (the CPU, or ranks sharing one card) or nccl "
                    "(a card a rank)")
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    res = run(args.world, args.device, args.backend, args.steps)
    print(json.dumps(res, indent=1))
    if not res["constant"]:
        raise SystemExit("the bytes of a step depend on the photon load")


if __name__ == "__main__":
    main()
