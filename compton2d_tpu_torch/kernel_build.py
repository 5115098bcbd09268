"""Build and bind the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with nvcc for sm_90a (no fused multiply-add, IEEE
division and square root, no fast math) into a shared library under
``_build/`` whose name carries the source's stem and a hash of the
source and the flags, so a checkout compiles each kernel once and every
later process only loads it. A kernel module (``transport.flight``,
``fp.update``) loads its library with ctypes and checks each operand with
:func:`check` before a launch.
"""
from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(source: Path) -> Path:
    """Build output for ``source`` and the flags (hash-keyed, named after
    the source: ``flight_<hash>.so`` for ``csrc/flight.cu``)."""
    h = hashlib.sha256(Path(source).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}_{h.hexdigest()[:16]}.so"


def compile_source(source: Path) -> Path:
    """Compile ``source`` with nvcc for sm_90a into its hash-keyed library
    if that is missing, keeping ptxas's report beside it (``.ptxas.txt``).
    Returns the library's path."""
    path = library_path(source)
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stderr}"
                )
            path.with_suffix(".ptxas.txt").write_text(proc.stderr)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return path


def ptxas_text(source: Path) -> str:
    """ptxas's report of ``source``'s build (:func:`compile_source`)."""
    return library_path(source).with_suffix(".ptxas.txt").read_text()


def ptxas_entry(source: Path, entry: str) -> str:
    """ptxas's registers, stack and spills for the entry function whose
    name holds ``entry`` in ``source``'s build."""
    keep, out = False, []
    for ln in ptxas_text(source).splitlines():
        if "Compiling entry function" in ln:
            keep = entry in ln
        elif keep and re.search(r"registers|spill|stack", ln):
            out.append(ln.replace("ptxas info    : ", "").strip())
    return "; ".join(out) or ptxas_text(source).strip()


def check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless the kernel operand ``t`` is on ``device``, of
    ``dtype`` and ``shape``, and contiguous."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
