"""Multi-process bring-up (counterpart of
``compton2d_tpu.parallel.distributed``).

The reference scales with MPI ranks exchanging photons through a master
(``imcredist.f``, ``vol_mpi.f``, ``surf_mpi.f`` of the Fortran
reference); the port replaces every one of those patterns with one
process per rank over ``torch.distributed`` (see ``parallel.mesh``): zone
state is built alike on every rank, every rank owns an equal share of the
photon slots, tallies reduce in rank order, and under ``run.zone_shard``
the zone work is split over the ranks.

Each rank spools only its own escaping-photon records, to its own event
file ``pNNN_<name>`` (:func:`process_event_path`), as the reference's
ranks write ``pNNN_evb.dat``; each writes its own checkpoint shard
(``io.checkpoint``).

The backend is the caller's choice and a rank never changes it: ``nccl``
where each rank has a card of its own, ``gloo`` on the CPU and for ranks
that share one card (NCCL refuses two ranks on one device).

Usage, one process per rank under torchrun (which sets ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` and ``LOCAL_RANK``)::

    from compton2d_tpu_torch.parallel import distributed as dist
    dist.initialize(backend="nccl")
    mesh = dist.global_photon_mesh()
    sim = Simulation(cfg, zones, mesh=mesh)

or, from one parent process, :func:`run_ranks` (``spawn``ed ranks and a
``file://`` rendezvous; the tests and ``chip_smoke.py`` use it).
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist

from compton2d_tpu_torch.parallel.mesh import PhotonMesh, make_photon_mesh


def initialize(init_method: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: str = "nccl", timeout_s: float = 120.0) -> None:
    """``torch.distributed.init_process_group`` (idempotent). With no
    ``init_method`` the rendezvous is torchrun's environment (``env://``:
    ``MASTER_ADDR``, ``MASTER_PORT``, and ``RANK``, ``WORLD_SIZE`` unless
    given). ``timeout_s`` bounds the rendezvous and every collective."""
    if dist.is_initialized():
        return
    dist.init_process_group(
        backend=backend, init_method=init_method or "env://",
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def global_photon_mesh(device=None) -> PhotonMesh:
    """The photon mesh over every rank of the default group."""
    return make_photon_mesh(device)


def process_event_path(path: str, rank: int) -> str:
    """Per-rank event-file name, ``pNNN_<name>`` like the reference
    (xec2d.f evlfilename)."""
    d, b = os.path.split(path)
    return os.path.join(d, f"p{rank:03d}_{b}")


def _rank_main(rank: int, world: int, init_method: str, backend: str,
               timeout_s: float, device, threads: Optional[int],
               fn: Callable, args: tuple, results) -> None:
    try:
        if threads:
            torch.set_num_threads(threads)
        initialize(init_method, world, rank, backend, timeout_s)
        try:
            out = fn(global_photon_mesh(device), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, None, out))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
        raise


def run_ranks(fn: Callable, world: int, args: tuple = (), *,
              backend: str, device, rendezvous_dir: str,
              timeout_s: float = 300.0, init_timeout_s: float = 120.0,
              threads: Optional[int] = None) -> list:
    """Run ``fn(mesh, *args)`` in ``world`` new (``spawn``ed) processes, one
    a rank, on ``device`` (a device for every rank, or None for
    :func:`rank_device <compton2d_tpu_torch.parallel.mesh.rank_device>`)
    and return their results in rank order. ``fn`` and its arguments and
    results are pickled, so ``fn`` is a module-level function and results
    live on the host. The ranks meet through a ``file://`` rendezvous in
    ``rendezvous_dir``, an existing directory. Raises RuntimeError with
    the traceback when a rank raises or exits non-zero, and TimeoutError
    when the ranks are not done within ``timeout_s``; either way every
    rank is stopped first."""
    fd, rdv = tempfile.mkstemp(prefix="rdv_", dir=rendezvous_dir)
    os.close(fd)
    os.remove(rdv)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, "file://" + rdv, backend, init_timeout_s, device, threads,
        fn, args, results), daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    out, done, suspect = [None] * world, set(), set()
    deadline = time.monotonic() + timeout_s
    try:
        while len(done) < world:
            try:
                rank, err, res = results.get(timeout=1.0)
            except queue.Empty:
                # a rank that exited has flushed its result: a second
                # empty wait means it sent none
                dead = {r for r, p in enumerate(procs)
                        if r not in done and p.exitcode is not None}
                if dead and dead <= suspect:
                    raise RuntimeError(f"ranks {sorted(dead)} of {world} "
                                       "exited without a result")
                suspect = dead
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks not done in "
                                       f"{timeout_s} s")
                continue
            if err is not None:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{err}")
            out[rank] = res
            done.add(rank)
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
            if p.exitcode != 0:
                raise RuntimeError(f"a rank exited with {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
        results.close()
        if os.path.exists(rdv):
            os.remove(rdv)
    return out
