"""ctypes bindings to the native C++ event-processing library (the port's
counterpart of ``compton2d_tpu.io.native``).

Builds ``compton2d_tpu_torch/csrc/evtproc.cpp`` (a host library, a copy of
the JAX package's) with ``g++ -O3 -shared -fPIC`` at first use, into the
package's ``_build/`` directory under a name keyed by a hash of the source
and the flags. A failed build raises with the compiler's stderr: there is
no numpy fallback, so a missing compiler shows and no run silently takes
the slow path. The numpy versions of the binning stay in
:mod:`compton2d_tpu_torch.io.postprocess`, which the tests hold this
library against.

The native layer mirrors the reference's C post-processors
(``plcm.c``/``pspt.c``): streaming parse of 7-column text event files,
Doppler light-curve/SED binning of millions of records, and the e14.7
text formatting of the event files (``evt_write_rows``, the bytes of
``np.savetxt(fmt="%14.7e")``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from compton2d_tpu_torch.io import postprocess as pp

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "evtproc.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_LIB: Optional[ctypes.CDLL] = None


def library_path(source: Path = SOURCE) -> Path:
    """Build output for ``source`` and the flags (hash-keyed)."""
    h = hashlib.sha256(Path(source).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"evtproc_{h.hexdigest()[:16]}.so"


def build(source: Path = SOURCE, cxx: str = "g++") -> Path:
    """Compile ``source`` into its hash-keyed library if that is missing;
    returns its path. Raises RuntimeError with the compiler's stderr when
    the build fails."""
    path = library_path(source)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        try:
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(source)],
                                  capture_output=True, text=True, timeout=300)
        except OSError as e:
            raise RuntimeError(f"{cxx} could not run: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}) on "
                               f"{source}:\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _load() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    c_dp = ctypes.POINTER(ctypes.c_double)
    lib.evt_count_rows.restype = ctypes.c_int64
    lib.evt_count_rows.argtypes = [ctypes.c_char_p]
    lib.evt_read.restype = ctypes.c_int64
    lib.evt_read.argtypes = [ctypes.c_char_p, c_dp, ctypes.c_int64]
    lib.evt_doppler_lc.restype = None
    lib.evt_doppler_lc.argtypes = [
        c_dp, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        c_dp, ctypes.c_int64,
        c_dp, ctypes.c_int64,
        c_dp, c_dp, ctypes.c_int64,
        c_dp, c_dp, c_dp,
    ]
    lib.evt_write_rows.restype = ctypes.c_int64
    lib.evt_write_rows.argtypes = [ctypes.c_char_p, c_dp, ctypes.c_int64]
    lib.evt_doppler_sed.restype = None
    lib.evt_doppler_sed.argtypes = [
        c_dp, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double,
        c_dp, ctypes.c_int64,
        c_dp, c_dp,
    ]
    _LIB = lib
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def write_event_rows(path: str, rec: np.ndarray) -> int:
    """Append (n, 7) records to ``path`` in the reference's e14.7 text
    format (``np.savetxt(fmt="%14.7e")``'s bytes); returns the rows
    written. Raises OSError when the file cannot be written."""
    rec = np.ascontiguousarray(rec, np.float64).reshape(-1, 7)
    n = int(_load().evt_write_rows(os.fsencode(path), _ptr(rec),
                                   rec.shape[0]))
    if n < 0:
        raise OSError(f"evt_write_rows could not write {path}")
    return n


def read_event_file(path: str) -> np.ndarray:
    """Streaming parse of a 7-column event file into (n, 7) float64."""
    lib = _load()
    n = lib.evt_count_rows(os.fsencode(path))
    if n < 0:
        raise OSError(f"cannot open {path}")
    if n == 0:
        return np.zeros((0, 7))
    out = np.empty((n, 7), np.float64)
    got = lib.evt_read(os.fsencode(path), _ptr(out), n)
    return out[: max(got, 0)]


def light_curves(
    events: np.ndarray,
    gam_bulk: float,
    r_max: float,
    t_edges: np.ndarray,
    e_bands: np.ndarray,
    mu_edges: Optional[np.ndarray] = None,
    t_offset: float = 0.0,
) -> pp.LightCurves:
    """plcm.c's binning; the same LightCurves as ``postprocess.light_curves``
    returns."""
    lib = _load()
    if mu_edges is None:
        mu_edges = np.linspace(-1.0, 1.0, 11)
    events = np.ascontiguousarray(events, np.float64).reshape(-1, 7)
    t_edges = np.ascontiguousarray(t_edges, np.float64)
    mu_edges = np.ascontiguousarray(mu_edges, np.float64)
    eb = np.asarray(e_bands, np.float64).reshape(-1, 2)
    e_lo = np.ascontiguousarray(eb[:, 0])
    e_hi = np.ascontiguousarray(eb[:, 1])
    nt, nmu, nb = len(t_edges) - 1, len(mu_edges) - 1, len(eb)
    F = np.zeros((nt, nmu, nb))
    F2 = np.zeros((nt, nmu, nb))
    counts = np.zeros((nt, nmu, nb))
    lib.evt_doppler_lc(
        _ptr(events), events.shape[0],
        float(gam_bulk), float(r_max), float(t_offset),
        _ptr(t_edges), nt, _ptr(mu_edges), nmu,
        _ptr(e_lo), _ptr(e_hi), nb,
        _ptr(F), _ptr(F2), _ptr(counts),
    )
    return pp.LightCurves(t_edges=t_edges, mu_edges=mu_edges, e_bands=eb,
                          flux=F, flux_sq=F2, counts=counts)


def sed(
    events: np.ndarray,
    gam_bulk: float,
    r_max: float,
    t_start: float,
    t_end: float,
    e_edges: np.ndarray,
    mu_range: Tuple[float, float] = (-1.0, 1.0),
) -> pp.SED:
    """pspt.c's time-window spectrum; the same SED as ``postprocess.sed``
    returns."""
    lib = _load()
    events = np.ascontiguousarray(events, np.float64).reshape(-1, 7)
    e_edges = np.ascontiguousarray(e_edges, np.float64)
    ne = len(e_edges) - 1
    flux = np.zeros(ne)
    counts = np.zeros(ne)
    lib.evt_doppler_sed(
        _ptr(events), events.shape[0],
        float(gam_bulk), float(r_max),
        float(t_start), float(t_end),
        float(mu_range[0]), float(mu_range[1]),
        _ptr(e_edges), ne, _ptr(flux), _ptr(counts),
    )
    return pp.SED(e_edges=e_edges, flux=flux, counts=counts)
