"""The photon mesh over ``torch.distributed`` ranks (counterpart of
``compton2d_tpu.parallel.mesh``).

The reference's distributed structure (SURVEY.md §2.7) maps onto ranks
as:

- P1 replicated-state broadcast -> every rank builds the same zone
  fields, tables and clocks from the configuration (no transfer);
- P2 zone task farms            -> ``run.zone_shard``: each rank runs the
  zone-batched phases (``volume_em``, the pair tensors, the FP solve) on
  its slice of the zones and the slices are gathered
  (:func:`zone_slice`, :func:`zone_gather`);
- P3 photon-parallel tracking   -> each rank owns ``n_slots / world``
  photon slots, sources ``nst / world`` photons a step with weights over
  the global count, and tracks them with its own random stream;
- P4 tally tree-reductions      -> :func:`all_gather_sum`.

One process runs each rank (torch's idiom; the JAX package runs one
``shard_map`` over the devices of a process). A :class:`PhotonMesh` is a
handle on the default process group. Every cross-rank reduction is one
``all_gather`` of one flat byte buffer (:func:`exchange`) followed, on
every rank alike, by a sum in rank order (``acc = g[0]; acc = acc +
g[1]; ...``), an exact max or min, or a concatenation: so a result is
bitwise independent of the backend and of any reduction tree, and equal
on every rank. Integers are summed as integers. Under ``gloo`` the buffer
goes through host memory (gloo's CUDA support does not cover every
collective); under ``nccl`` it stays on the device.

The JAX package's sharding specs (``sharded_specs``, ``simstate_specs``,
``put_global``) have no counterpart: each rank builds the full initial
state itself and keeps only its own photon slots.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from compton2d_tpu_torch import telemetry as tm

SUM, MAX, MIN, CAT = "sum", "max", "min", "cat"


@dataclass
class PhotonMesh:
    """A process group seen from one rank, with the time this rank spent
    in its collectives (``comm_s``, host clock around each all_gather)
    and their count and bytes sent (``comm_calls``, ``comm_bytes``); while
    ``exchange_sizes`` is a list, each exchange appends its bytes to it
    (``compton2d_tpu_torch.collectives``)."""

    rank: int
    world: int
    backend: str
    device: torch.device
    comm_s: float = 0.0
    comm_calls: int = 0
    comm_bytes: int = 0
    exchange_sizes: Optional[list] = None


def rank_device(local_rank: int) -> torch.device:
    """The card of a rank: ``cuda:(local_rank % device_count)``."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "ranks on the CPU")
    return torch.device("cuda", local_rank % n)


def rank_seed(seed: int, rank: int) -> int:
    """The seed of a rank's random stream: ``seed`` itself on rank 0 (a
    world of one runs the single-process stream), and a stream of its own
    on each other rank (golden-ratio steps modulo 2^63)."""
    return seed if rank == 0 else (seed + rank * 0x9E3779B97F4A7C15) % (
        1 << 63)


def make_photon_mesh(device=None) -> PhotonMesh:
    """The mesh of the default process group seen from this rank.
    ``device`` defaults to :func:`rank_device` of torchrun's
    ``LOCAL_RANK`` (the group rank without it); a card becomes the
    process's current device."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized "
                           "(parallel.distributed.initialize)")
    rank = dist.get_rank()
    device = torch.device(device) if device is not None else rank_device(
        int(os.environ.get("LOCAL_RANK", rank)))
    if device.type == "cuda":
        # NCCL's communicators take the current device
        torch.cuda.set_device(device)
    return PhotonMesh(rank=rank, world=dist.get_world_size(),
                      backend=str(dist.get_backend()), device=device)


def exchange(mesh: PhotonMesh, parts: Sequence[Tuple[torch.Tensor, str]]
             ) -> list:
    """Reduce each ``(tensor, op)`` of ``parts`` over the ranks through one
    all_gather of one flat byte buffer: ``SUM`` in rank order (integers as
    integers), ``MAX``/``MIN`` elementwise, ``CAT`` the ranks' tensors
    joined along their first axis in rank order. The results lie on the
    device of their inputs and are equal on every rank."""
    flat = [t.detach().contiguous().reshape(-1).view(torch.uint8)
            for t, _ in parts]
    buf = torch.cat(flat)
    on_device = buf.device
    if mesh.backend == "gloo":
        buf = tm.read("mesh.buffer", buf, tm.to_host)
    elif buf.is_cuda:
        torch.cuda.synchronize(buf.device)
    gathered = [torch.empty_like(buf) for _ in range(mesh.world)]
    with tm.span("mesh.exchange"):
        t0 = time.perf_counter()
        dist.all_gather(gathered, buf)
        if buf.is_cuda:
            torch.cuda.synchronize(buf.device)
        mesh.comm_s += time.perf_counter() - t0
    mesh.comm_calls += 1
    mesh.comm_bytes += buf.numel()
    if mesh.exchange_sizes is not None:
        mesh.exchange_sizes.append(buf.numel())
    g = torch.stack(gathered).to(on_device)
    out, off = [], 0
    for (t, op), b in zip(parts, flat):
        x = g[:, off:off + b.numel()].contiguous().view(t.dtype).reshape(
            (mesh.world,) + tuple(t.shape))
        off += b.numel()
        if op == SUM:
            acc = x[0]
            for r in range(1, mesh.world):
                acc = acc + x[r]
        elif op == MAX:
            acc = torch.amax(x, dim=0)
        elif op == MIN:
            acc = torch.amin(x, dim=0)
        elif op == CAT:
            acc = x.reshape((-1,) + tuple(t.shape[1:]))
        else:
            raise ValueError(f"exchange: unknown op {op!r}")
        out.append(acc.to(t.device))
    return out


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for sub in tree for x in _leaves(sub)]


def _rebuild(tree, it):
    if isinstance(tree, torch.Tensor):
        return next(it)
    kids = [_rebuild(sub, it) for sub in tree]
    return type(tree)(*kids) if hasattr(tree, "_fields") else type(tree)(kids)


def all_gather_sum(mesh: PhotonMesh, tree):
    """Every tensor of ``tree`` (a tensor, or nested tuples and
    NamedTuples of tensors) summed over the ranks in rank order."""
    leaves = _leaves(tree)
    return _rebuild(tree, iter(exchange(mesh, [(x, SUM) for x in leaves])))


def all_max(mesh: PhotonMesh, x: torch.Tensor) -> torch.Tensor:
    return exchange(mesh, [(x, MAX)])[0]


def barrier(mesh: PhotonMesh) -> None:
    """Return once every rank has reached this call."""
    exchange(mesh, [(torch.zeros(1, dtype=torch.uint8, device=mesh.device),
                     SUM)])


# ---------------------------------------------------------------------------
# the zone farm: the zones split into ceil(Z / world) per rank
# ---------------------------------------------------------------------------
def zones_per_rank(mesh: PhotonMesh, n_zones: int) -> int:
    return -(-n_zones // mesh.world)


def zone_slice_flat(mesh: PhotonMesh, x: torch.Tensor) -> torch.Tensor:
    """(Z, ...) -> this rank's (Zs, ...) slice, Zs = ceil(Z / world). The
    zone axis is padded to Zs * world by repeating the last zone; the
    caller makes pad zones inert (``zone_valid``)."""
    z = x.shape[0]
    zs = zones_per_rank(mesh, z)
    pad = zs * mesh.world - z
    if pad:
        x = torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))])
    return x[mesh.rank * zs:(mesh.rank + 1) * zs].contiguous()


def zone_slice(mesh: PhotonMesh, x: torch.Tensor) -> torch.Tensor:
    """(nz, nr, ...) -> this rank's zones as a (Zs, 1, ...) grid."""
    s = zone_slice_flat(mesh, x.reshape((-1,) + tuple(x.shape[2:])))
    return s.reshape((s.shape[0], 1) + tuple(s.shape[1:]))


def zone_valid(mesh: PhotonMesh, n_zones: int, device) -> torch.Tensor:
    """(Zs, 1) bool: which zones of this rank's slice are real."""
    zs = zones_per_rank(mesh, n_zones)
    idx = torch.arange(mesh.rank * zs, (mesh.rank + 1) * zs, device=device)
    return (idx < n_zones).reshape(zs, 1)


def zone_gather(mesh: PhotonMesh, tree, nz: int, nr: int, extra=()):
    """Each rank's zone slices of ``tree`` (tensors or a NamedTuple of
    them, each (Zs, 1, ...) or (Zs, ...)) joined into (nz, nr, ...), in one
    exchange with the ``(tensor, op)`` pairs of ``extra``, whose results
    follow: ``(gathered tree, *extra results)``."""
    leaves = _leaves(tree)
    flat = [x.reshape((x.shape[0],) + tuple(x.shape[2:]))
            if x.dim() >= 2 and x.shape[1] == 1 else x for x in leaves]
    res = exchange(mesh, [(x, CAT) for x in flat] + list(extra))
    z = nz * nr
    full = [g[:z].reshape((nz, nr) + tuple(g.shape[1:]))
            for g in res[:len(flat)]]
    return (_rebuild(tree, iter(full)), *res[len(flat):])
