"""The corona of ``examples.small_corona`` on a photon mesh, one process
per rank, started by torchrun::

    torchrun --nproc-per-node 2 -m compton2d_tpu_torch.run_sharded \\
        --backend gloo --device cpu --nz 3 --nr 2 --nst 3000 \\
        --n-slots 4096 --num-nt 50 --n-vol 64 --nphfield 64 --steps 3

(``--backend nccl --device cuda`` where each rank has a card of its own;
``gloo`` for ranks on the CPU or sharing one card). Each step rank 0
prints the energy audit's balance, a sha256 of the step's tallies (the
same on every rank, and for either backend: the reductions sum in rank
order) and the summary; at the end every rank prints its ms/step and the
time it spent in collectives.
"""
from __future__ import annotations

import argparse
import hashlib
import time

import torch
import torch.distributed as dist

from compton2d_tpu_torch.examples import small_corona
from compton2d_tpu_torch.parallel import distributed


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--backend", choices=("nccl", "gloo"), required=True)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda: the rank's card (LOCAL_RANK modulo the "
                        "device count)")
    p.add_argument("--nz", type=int, default=8)
    p.add_argument("--nr", type=int, default=4)
    p.add_argument("--nst", type=int, default=60000)
    p.add_argument("--n-slots", type=int, default=1 << 17)
    p.add_argument("--num-nt", type=int, default=200)
    p.add_argument("--n-vol", type=int, default=400)
    p.add_argument("--nphfield", type=int, default=400)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    distributed.initialize(backend=args.backend)
    try:
        mesh = distributed.global_photon_mesh(
            None if args.device == "cuda" else "cpu")
        sim = small_corona(
            nz=args.nz, nr=args.nr, nst=args.nst, n_slots=args.n_slots,
            num_nt=args.num_nt, n_vol=args.n_vol, nphfield=args.nphfield,
            t_const=False, seed=args.seed, device=mesh.device, mesh=mesh)

        def sync():
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)

        sync()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            out = sim.step()
            balance = sim.energy_audit()["balance"]
            if mesh.rank == 0:
                h = hashlib.sha256()
                for t in out.tallies:
                    h.update(t.cpu().reshape(-1).view(torch.uint8).numpy()
                             .tobytes())
                print(f"balance {balance:.7f} tallies {h.hexdigest()[:16]} "
                      f"{sim.summary()}", flush=True)
        sync()
        elapsed = time.perf_counter() - t0
        print(f"rank {mesh.rank}/{mesh.world} on {mesh.device} "
              f"({mesh.backend}): {1e3 * elapsed / args.steps:.3f} ms/step, "
              f"collectives {1e3 * mesh.comm_s / args.steps:.3f} ms/step in "
              f"{mesh.comm_calls} all_gathers", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
