"""Carry state across from the JAX reference to the port.

The reference's ``SimState``, ``Tables``, ``Grid`` and ``SourceStatic``
arrive as flat dicts of numpy arrays keyed by dotted field names
(``"zones.tea"``, ``"photons.e"``, ``"gamma_bar.log_theta"``, ...), as
:func:`flatten` makes them from any NamedTuple whose leaves
``np.asarray`` accepts. :func:`from_reference` rebuilds the port's
NamedTuples on a device, so both packages can run from the same state;
the spectrum bank comes across inside the ``SourceStatic`` (the
reference's quantile table, ``spec_inv``, has no counterpart, and its
Planck CDF is the port's own),
:func:`track_reflection` takes the reflection tables of a reference
``TrackContext`` and :func:`coulomb_tables` its ``CoulombTables``;
:func:`shard_photons` cuts a reference census into the ranks' shares of a
photon mesh. This module never imports jax.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from compton2d_tpu_torch.grid import Grid
from compton2d_tpu_torch.physics.coulomb import CoulombTables
from compton2d_tpu_torch.physics.electron_dist import GammaBarTable
from compton2d_tpu_torch.physics.emissivity import SyncKernelTable
from compton2d_tpu_torch.physics.planck import CDF_M
from compton2d_tpu_torch.state import PhotonArray, SimState, ZoneState
from compton2d_tpu_torch.tables import PairTables, Tables
from compton2d_tpu_torch.transport.sourcing import SourceStatic


def flatten(obj, prefix: str = "") -> Dict[str, np.ndarray]:
    """NamedTuple (nested) -> {dotted field name: np.asarray(leaf)}."""
    out: Dict[str, np.ndarray] = {}
    for name in obj._fields:
        leaf = getattr(obj, name)
        key = prefix + name
        if hasattr(leaf, "_fields"):
            out.update(flatten(leaf, key + "."))
        else:
            out[key] = np.asarray(leaf)
    return out


def shard_photons(photons: Dict[str, np.ndarray], rank: int, world: int
                  ) -> Dict[str, np.ndarray]:
    """One rank's share of a global photon SoA (any dict of arrays whose
    leading axis is the slot, such as the ``"photons.*"`` entries of a
    flattened reference state) as the JAX package's mesh lays it out:
    rank ``i`` of ``world`` owns slots ``[i n / world, (i + 1) n /
    world)``, the port's rank ``i`` the same slots."""
    n = {a.shape[0] for a in map(np.asarray, photons.values())}
    if len(n) != 1 or next(iter(n)) % world:
        raise ValueError(f"slot counts {sorted(n)} do not split over "
                         f"{world} ranks")
    m = next(iter(n)) // world
    return {k: np.asarray(v)[rank * m:(rank + 1) * m]
            for k, v in photons.items()}


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)   # a private, writable copy of the caller's buffer
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.as_tensor(a, device=device)


def _build(cls, d: Dict[str, np.ndarray], prefix: str, device,
           nested=None):
    nested = nested or {}
    kw = {}
    for name in cls._fields:
        if name in nested:
            kw[name] = _build(nested[name], d, prefix + name + ".", device)
        else:
            kw[name] = _tensor(d[prefix + name], device)
    return cls(**kw)


def from_reference(
    state: Dict[str, np.ndarray], tables: Dict[str, np.ndarray],
    grid: Dict[str, np.ndarray], src: Dict[str, np.ndarray],
    device="cuda", seed: int = 0,
    pair_tables: Optional[Dict[str, np.ndarray]] = None,
) -> Tuple[SimState, Tables, Grid, SourceStatic, Optional[PairTables]]:
    """The port's (SimState, Tables, Grid, SourceStatic, PairTables) from
    flattened reference objects; the PairTables are None unless the
    reference's flattened ``pair_tables`` are given. The reference's
    threefry key has no counterpart: the port's ``state.key`` is a new
    generator seeded with ``seed``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    kw = {}
    for name in SimState._fields:
        if name == "zones":
            kw[name] = _build(ZoneState, state, "zones.", dev)
        elif name == "photons":
            kw[name] = _build(PhotonArray, state, "photons.", dev)
        elif name == "key":
            kw[name] = gen
        else:
            kw[name] = _tensor(state[name], dev)
    sim_state = SimState(**kw)
    tab = _build(Tables, tables, "", dev, nested={
        "sync": SyncKernelTable, "gamma_bar": GammaBarTable})
    return (
        sim_state,
        tab,
        _build(Grid, grid, "", dev),
        _build(SourceStatic, {**src, "planck_cdf": CDF_M}, "", dev),
        None if pair_tables is None
        else _build(PairTables, pair_tables, "", dev),
    )


def track_reflection(ctx: Dict[str, np.ndarray], device="cuda"
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reflection tables of a flattened reference ``TrackContext``
    (``e_ref``, ``p_ref_t``, ``w_abs_t``: the tables the port's
    ``TrackContext`` carries under the same names) on ``device``."""
    dev = torch.device(device)
    return tuple(_tensor(ctx[name], dev)
                 for name in ("e_ref", "p_ref_t", "w_abs_t"))


def coulomb_tables(tables: Dict[str, np.ndarray], device="cuda"
                   ) -> CoulombTables:
    """The port's CoulombTables from a flattened reference
    ``CoulombTables`` (the same field names), on ``device``."""
    return _build(CoulombTables, tables, "", torch.device(device))
