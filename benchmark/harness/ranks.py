"""A cell on several ranks: one spawned process a rank, one card each,
meeting through a ``file://`` rendezvous in a temporary directory under
TMPDIR (as the port's ``parallel.distributed.run_ranks`` does). Each rank
runs the whole cell and sends its record back; every rank is stopped
and waited for before the parent goes on."""
from __future__ import annotations

import datetime
import multiprocessing as mp
import queue
import tempfile
import time
import traceback

RANK_TIMEOUT_S = 330.0


def _rank(rank: int, world: int, init: str, backend: str, args, t_wall,
          device_type: str, root, before, results) -> None:
    try:
        import torch
        import torch.distributed as dist
        from compton2d_tpu_torch.parallel.mesh import make_photon_mesh
        import run as entry

        device = torch.device(device_type, rank if device_type == "cuda"
                              else None)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        if before is not None:
            before()
        dist.init_process_group(backend=backend, init_method=init,
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=120))
        try:
            rec = entry.run_rank(args, device, make_photon_mesh(device),
                                 t_wall, root)
        finally:
            dist.destroy_process_group()
        results.put((rank, None, rec))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
        raise


def run(args, world: int, backend: str, device_type: str = "cuda",
        root=None, before=None) -> list:
    """The ranks' records, in rank order (each rank first calls
    ``before``, a module-level function, when given); raises RuntimeError when a rank
    fails and TimeoutError when they are not done in time."""
    from compton2d_tpu_torch.transport import flight
    import run as entry

    if device_type == "cuda":
        flight.build()      # once, before the ranks load it
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="c2d_rdv_") as d:
        init = f"file://{d}/rendezvous"
        procs = [ctx.Process(target=_rank, args=(
            r, world, init, backend, args, entry.T_WALL, device_type,
            root or entry.specs.ROOT, before, results))
            for r in range(world)]
        for p in procs:
            p.start()
        out = [None] * world
        deadline = time.monotonic() + RANK_TIMEOUT_S
        try:
            while any(o is None for o in out):
                try:
                    rank, err, rec = results.get(timeout=1.0)
                except queue.Empty:
                    if any(p.exitcode not in (None, 0) for p in procs):
                        raise RuntimeError("a rank exited without a record")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{world} ranks not done")
                    continue
                if err is not None:
                    raise RuntimeError(f"rank {rank} failed:\n{err}")
                out[rank] = rec
            for p in procs:
                p.join(max(deadline - time.monotonic(), 5.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join(10)
            results.close()
    return out
