"""Escaping-photon event records (the port's copy of
``compton2d_tpu.io.events``).

The reference writes every escaping photon to per-rank text event files
``pNNN_<name>`` in a 7-column e14.7 format
(``src/imcleak2d.f:105,181`` of the Fortran reference):

    t_bound  xnu  ew  rpre  zpre  wmu  phi

Those files are both the science output and the input of the C
post-processors (``postprocessing/plcm.c:384``). The device accumulates a
fixed-capacity EventBuffer per step; the host flushes it. Under a photon
mesh each rank flushes its own records to its own file
(``parallel.distributed.process_event_path``).

Two sinks:
- :class:`EventFileWriter` — reference-format text file, formatted by the
  native library (:func:`compton2d_tpu_torch.io.native.write_event_rows`,
  as the JAX package's writer formats it; byte for byte the text of
  ``np.savetxt(fmt="%14.7e")``);
- :class:`EventArrayStore` — in-memory numpy stack for the post-processing
  in :mod:`compton2d_tpu_torch.io.postprocess`.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from compton2d_tpu_torch import telemetry as tm
from compton2d_tpu_torch.io import native


def _to_host(arr) -> np.ndarray:
    """A torch tensor (on any device) or array-like as numpy."""
    if isinstance(arr, torch.Tensor):
        return tm.read("outputs.events", arr.detach(), tm.to_host).numpy()
    return np.asarray(arr)


def buffer_to_numpy(events, energy_scale: float) -> np.ndarray:
    """Extract valid records as (n, 7) float64, weights converted to erg.

    ``events.data`` may stack several per-device buffers: shape
    (ndev*cap, 7) with counts (ndev,).
    """
    data = np.asarray(_to_host(events.data), np.float64)
    counts = np.atleast_1d(_to_host(events.count))
    ndev = counts.shape[0]
    cap = data.shape[0] // ndev
    rows: List[np.ndarray] = []
    for d in range(ndev):
        n = int(min(counts[d], cap))
        rows.append(data[d * cap: d * cap + n])
    out = np.concatenate(rows, axis=0) if rows else np.zeros((0, 7))
    out[:, 2] *= energy_scale  # ew -> erg
    return out


def _n_dropped(events) -> int:
    counts = np.atleast_1d(_to_host(events.count))
    cap = events.data.shape[0] // counts.shape[0]
    return int(np.sum(np.maximum(counts - cap, 0)))


class EventFileWriter:
    """Append reference-format event records to a text file."""

    def __init__(self, path: str, energy_scale: float, append: bool = False):
        """``append``: continue the file of the run this one resumes (the
        reference's writer truncates here too, so a resumed run of the
        JAX package loses the records written before its checkpoint).
        Otherwise the file starts empty, so a re-run into an existing path
        never mixes stale records with new ones."""
        self.path = path
        self.energy_scale = energy_scale
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # the native formatter appends by path: create (or truncate) the
        # file here, and build the library before the first step
        with open(path, "a" if append else "w"):
            pass
        native.build()
        self.n_written = 0
        self.n_dropped = 0

    def write(self, events) -> int:
        rec = buffer_to_numpy(events, self.energy_scale)
        self.n_dropped += _n_dropped(events)
        self.n_written += native.write_event_rows(self.path, rec)
        return rec.shape[0]


class EventArrayStore:
    """Accumulate event records in memory for the post-processing."""

    def __init__(self, energy_scale: float):
        self.energy_scale = energy_scale
        self._chunks: List[np.ndarray] = []
        self.n_dropped = 0

    def write(self, events) -> int:
        rec = buffer_to_numpy(events, self.energy_scale)
        self.n_dropped += _n_dropped(events)
        self._chunks.append(rec)
        return rec.shape[0]

    def all(self) -> np.ndarray:
        if not self._chunks:
            return np.zeros((0, 7))
        return np.concatenate(self._chunks, axis=0)


def read_event_file(path: str) -> np.ndarray:
    """Read a reference-format event file into (n, 7) float64."""
    with tm.span("outputs.read_events"):
        return np.loadtxt(path).reshape(-1, 7)
