"""The port's native event library (``compton2d_tpu_torch.io.native``,
``csrc/evtproc.cpp``) against the JAX package's writer and native
library, ``np.savetxt`` and the port's numpy post-processing."""
import io
from collections import namedtuple
from pathlib import Path

import numpy as np
import pytest
import torch

from compton2d_tpu.io import events as jev
from compton2d_tpu.io import native as jnative
from compton2d_tpu_torch.io import events as pev
from compton2d_tpu_torch.io import native, postprocess

REPO = Path(__file__).resolve().parent.parent
Buffer = namedtuple("Buffer", "data count")


def _records(n=3000, seed=0):
    """Event rows with the reference's columns: time, energy, weight (in
    the energy unit), r, z, mu, phi, over many decades and both signs."""
    rng = np.random.default_rng(seed)
    return np.stack([
        rng.uniform(0.0, 7e4, n),
        10.0 ** rng.uniform(-8.0, 10.0, n),
        10.0 ** rng.uniform(-30.0, -5.0, n),
        rng.uniform(0.0, 2.5e15, n),
        rng.uniform(-1e15, 1e16, n),
        rng.uniform(-1.0, 1.0, n),
        rng.uniform(0.0, 2.0 * np.pi, n),
    ], axis=1)


def _buffers(rec, cap):
    """The records as per-step event buffers of ``cap`` rows (numpy for
    the JAX writer, float32 tensors for the port's)."""
    out = []
    for i in range(0, len(rec), cap):
        chunk = rec[i:i + cap].astype(np.float32)
        data = np.zeros((cap, 7), np.float32)
        data[:len(chunk)] = chunk
        out.append((Buffer(data, np.array([len(chunk)], np.int32)),
                    Buffer(torch.from_numpy(data),
                           torch.tensor([len(chunk)], dtype=torch.int32))))
    return out


def test_source_is_the_reference_copy():
    """From the first include directive on, the port's evtproc.cpp is the JAX
    package's text."""
    a = (REPO / "compton2d_tpu" / "native" / "evtproc.cpp").read_text()
    b = native.SOURCE.read_text()
    assert b[b.index("#include"):] == a[a.index("#include"):]


def test_builds_only_into_the_ports_build_dir():
    path = native.build()
    assert path.parent == REPO / "compton2d_tpu_torch" / "_build"
    assert path == native.library_path()
    assert path.exists()


def test_event_file_byte_equal_to_jax_writer_and_savetxt(tmp_path):
    """Three steps of records through the port's writer (the native
    formatter), the JAX package's writer and np.savetxt: the same bytes;
    the native parse reads them back as np.loadtxt does."""
    scale = 3.7e41
    rec = _records()
    bufs = _buffers(rec, 1024)
    pw = pev.EventFileWriter(str(tmp_path / "p" / "evb.dat"), scale)
    jw = jev.EventFileWriter(str(tmp_path / "j" / "evb.dat"), scale)
    want = io.BytesIO()
    for jb, pb in bufs:
        assert pw.write(pb) == jw.write(jb) == int(pb.count[0])
        np.savetxt(want, jev.buffer_to_numpy(jb, scale), fmt="%14.7e")
    jw.close()
    got = (tmp_path / "p" / "evb.dat").read_bytes()
    assert got == (tmp_path / "j" / "evb.dat").read_bytes()
    assert got == want.getvalue()
    assert pw.n_written == len(rec)
    back = native.read_event_file(str(tmp_path / "p" / "evb.dat"))
    np.testing.assert_array_equal(back,
                                  np.loadtxt(tmp_path / "p" / "evb.dat"))
    np.testing.assert_array_equal(
        back, pev.read_event_file(str(tmp_path / "p" / "evb.dat")))


def test_writer_truncates_or_appends(tmp_path):
    """A new writer starts the file empty; a resumed one appends."""
    scale = 1.0
    (jb, pb), (jb2, pb2) = _buffers(_records(200, 1), 100)
    path = str(tmp_path / "evb.dat")
    w = pev.EventFileWriter(path, scale)
    w.write(pb)
    first = Path(path).read_bytes()
    pev.EventFileWriter(path, scale, append=True).write(pb2)
    both = Path(path).read_bytes()
    assert both.startswith(first) and len(both) > len(first)
    w = pev.EventFileWriter(path, scale)
    assert Path(path).read_bytes() == b""
    w.write(pb)
    assert Path(path).read_bytes() == first


def test_read_round_trip(tmp_path):
    rec = _records(500, 2)
    path = str(tmp_path / "e.dat")
    assert native.write_event_rows(path, rec) == len(rec)
    back = native.read_event_file(path)
    np.testing.assert_allclose(back, rec, rtol=6e-8)
    (tmp_path / "empty.dat").touch()
    assert native.read_event_file(str(tmp_path / "empty.dat")).shape == (0, 7)
    with pytest.raises(OSError):
        native.read_event_file(str(tmp_path / "missing.dat"))


def test_light_curves_and_sed_match_numpy_and_jax_native():
    """plcm.c's light curves and pspt.c's SED: the native library against
    the port's numpy post-processing and the JAX package's native library
    on the same records (Mrk 421's Gamma, cone and bands)."""
    rec = _records(20000, 3)
    gam, r_max = 33.0, 2.5e15
    t_edges = np.linspace(0.0, 4e3, 41)
    bands = np.array([[1e-3, 3e-3], [2.0, 4.0], [9.0, 15.0], [5e5, 5e7],
                      [1e9, 1e10]])
    mu_edges = np.linspace(0.99, 1.0, 6)
    lc = native.light_curves(rec, gam, r_max, t_edges, bands, mu_edges)
    lc_np = postprocess.light_curves(rec, gam, r_max, t_edges, bands,
                                     mu_edges)
    lc_j = jnative.light_curves(rec, gam, r_max, t_edges, bands, mu_edges)
    assert lc.counts.sum() > 1000
    for f in ("flux", "flux_sq", "counts"):
        np.testing.assert_allclose(getattr(lc, f), getattr(lc_np, f),
                                   rtol=1e-12, err_msg=f)
        np.testing.assert_array_equal(getattr(lc, f), getattr(lc_j, f),
                                      err_msg=f)
    e_edges = np.logspace(-8, 10, 73)
    counts = []
    for mu_range in ((-1.0, 1.0), (0.99944, 0.99964)):
        s = native.sed(rec, gam, r_max, 0.0, 3e3, e_edges, mu_range)
        s_np = postprocess.sed(rec, gam, r_max, 0.0, 3e3, e_edges, mu_range)
        s_j = jnative.sed(rec, gam, r_max, 0.0, 3e3, e_edges, mu_range)
        np.testing.assert_allclose(s.flux, s_np.flux, rtol=1e-12)
        np.testing.assert_array_equal(s.counts, s_np.counts)
        np.testing.assert_array_equal(s.flux, s_j.flux)
        np.testing.assert_array_equal(s.counts, s_j.counts)
        counts.append(s.counts.sum())
    assert counts[0] > counts[1] > 0


def test_failing_build_raises_with_the_compilers_message(tmp_path,
                                                          monkeypatch):
    """A source that does not compile, and a compiler that does not
    exist, raise RuntimeError (no numpy fallback)."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match="bad.cpp"):
        native.build(bad)
    with pytest.raises(RuntimeError, match="could not run"):
        native.build(native.SOURCE, cxx=str(tmp_path / "no-such-g++"))
    assert not list((tmp_path / "build").glob("*.so"))
