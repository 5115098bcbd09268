"""Checkpoint / resume (the port's counterpart of
``compton2d_tpu.io.checkpoint``).

The Fortran reference dumps its whole COMMON block per rank to text files
(``write_record.f``/``read_record.f``) when 95 % of the assumed 8-hour
walltime is spent (``xec2d.f:24,50-55``), and resumes when
``p000_misc.dat`` exists (``compton2d.f:16-21``).

Here every tensor of ``SimState`` (the zone fields, the photon SoA with
its census population, the clocks, ``ed_abs``/``ed_ref``, ``k_gg`` and
the pair rates) and the state of its ``torch.Generator`` go to one
``.npz``, written to a temporary file and renamed over ``path``; the meta
dict (with the generator's device type added) goes beside it as
``path + ".meta.json"``. Every random draw of a step, the per-round
scatter seeds included, comes from that generator, so a resumed run
continues bit for bit. A CUDA generator's state (Philox seed and offset)
is not a CPU generator's (mt19937): a checkpoint is restored only onto
the device type that wrote it.

Under a photon mesh of more than one rank (``parallel.mesh``) the layout
is the JAX package's multi-process one (compton2d_tpu/io/checkpoint.py:
43-100), the analogue of the reference's per-rank ``pNNN_misc.dat`` and
``pNNN_census.dat``: each rank writes its photon slots and its
generator's state to ``path.pNNN.npz``, rank 0 writes the tensors that
are the same on every rank, with the number of ranks (``_nproc``), to
``path`` and the meta beside it, and every rank returns once all have
written. A checkpoint resumes only under the number of ranks that wrote
it (a mesh of one rank writes the single-process layout).
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from compton2d_tpu_torch.parallel import mesh as pmesh
from compton2d_tpu_torch.state import PhotonArray, SimState, ZoneState

_KEY = "key"
_NPROC = "_nproc"


def _world(mesh: Optional[pmesh.PhotonMesh]) -> int:
    return 1 if mesh is None else mesh.world


def shard_path(path: str, rank: int) -> str:
    """The file of one rank's photon slots and generator: ``path.pNNN.npz``."""
    return f"{path}.p{rank:03d}.npz"


def _flatten(state: SimState) -> Dict[str, torch.Tensor]:
    """{dotted field name: tensor} of every tensor in ``state``."""
    out = {}
    for name in SimState._fields:
        leaf = getattr(state, name)
        if name == _KEY:
            continue
        if hasattr(leaf, "_fields"):
            for sub in leaf._fields:
                out[f"{name}.{sub}"] = getattr(leaf, sub)
        else:
            out[name] = leaf
    return out


def _atomic_write(path: str, write) -> None:
    """``write(fh)`` into a temporary file beside ``path``, flushed to
    disk, then renamed over ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        write(fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def save_checkpoint(path: str, state: SimState, meta: Optional[dict] = None,
                    mesh: Optional[pmesh.PhotonMesh] = None) -> None:
    """Dump every tensor of ``state`` and its generator's state to
    ``path``, and ``meta`` with the generator's device type (key
    ``"key_device"``) to ``path + ".meta.json"``; under a ``mesh`` of more
    than one rank, in the per-rank layout (every rank calls this)."""
    arrays = {k: v.detach().cpu().numpy() for k, v in _flatten(state).items()}
    arrays[_KEY] = state.key.get_state().numpy()
    device_type = state.key.device.type
    arrays["key_device"] = np.asarray(device_type)
    meta = dict(meta or {}, key_device=device_type)
    if _world(mesh) == 1:
        _atomic_write(path, lambda fh: np.savez(fh, **arrays))
    else:
        local = {k: arrays.pop(k) for k in list(arrays)
                 if k.startswith("photons.") or k in (_KEY, "key_device")}
        _atomic_write(shard_path(path, mesh.rank),
                      lambda fh: np.savez(fh, **local))
        arrays[_NPROC] = np.asarray(mesh.world)
        if mesh.rank == 0:
            _atomic_write(path, lambda fh: np.savez(fh, **arrays))
    if mesh is None or mesh.rank == 0:
        _atomic_write(path + ".meta.json",
                      lambda fh: fh.write(json.dumps(meta).encode()))
    if _world(mesh) > 1:
        pmesh.barrier(mesh)


def load_checkpoint(path: str, like_state: SimState,
                    mesh: Optional[pmesh.PhotonMesh] = None) -> SimState:
    """The state saved by :func:`save_checkpoint`, on the device of
    ``like_state``, whose shapes and dtypes it must have (under a
    ``mesh``, this rank's shard). Raises ValueError when the checkpoint
    was written by another number of ranks, its generator was on another
    device type than ``like_state.key``, or a tensor does not match."""
    device = like_state.key.device
    like = _flatten(like_state)
    with np.load(path) as repl:
        saved = int(repl[_NPROC]) if _NPROC in repl.files else 1
        if saved != _world(mesh):
            raise ValueError(
                f"checkpoint {path}: written by {saved} ranks, resuming "
                f"with {_world(mesh)}")
        data = dict(repl)
    if saved > 1:
        with np.load(shard_path(path, mesh.rank)) as local:
            data.update(local)
    saved_type = str(data["key_device"])
    if saved_type != device.type:
        raise ValueError(
            f"checkpoint {path}: its random stream is a {saved_type} "
            f"generator's, the run's is on {device.type}; resume on "
            f"{saved_type}")
    tensors = {}
    for name, ref in like.items():
        t = torch.from_numpy(data[name])
        if t.shape != ref.shape or t.dtype != ref.dtype:
            raise ValueError(
                f"checkpoint {path}: {name} is {t.dtype}"
                f"{tuple(t.shape)}, the run's {ref.dtype}"
                f"{tuple(ref.shape)}")
        tensors[name] = t.to(ref.device)
    gen = torch.Generator(device=device)
    gen.set_state(torch.from_numpy(data[_KEY].copy()))

    def group(cls, prefix):
        return cls(**{f: tensors[f"{prefix}.{f}"] for f in cls._fields})

    kw = {}
    for name in SimState._fields:
        if name == "zones":
            kw[name] = group(ZoneState, name)
        elif name == "photons":
            kw[name] = group(PhotonArray, name)
        elif name == _KEY:
            kw[name] = gen
        else:
            kw[name] = tensors[name]
    return SimState(**kw)


def load_meta(path: str) -> dict:
    with open(path + ".meta.json") as fh:
        return json.load(fh)


class WalltimeGuard:
    """Self-checkpoint trigger at a fraction of the walltime budget
    (xec2d.f:50-55: 95 % of 8 h)."""

    def __init__(self, budget_s: float, frac: float = 0.95):
        self.t0 = time.time()
        self.budget_s = budget_s
        self.frac = frac

    def should_checkpoint(self) -> bool:
        if self.budget_s <= 0:
            return False
        return (time.time() - self.t0) >= self.frac * self.budget_s
