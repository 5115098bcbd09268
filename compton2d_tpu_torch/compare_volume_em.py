"""The synchrotron sums kernel (``csrc/volume_em.cu``) against its plain
PyTorch version (``physics.emissivity.sync_sums_reference``) on the same
inputs, as the card tests (``tests/test_torch_volume_em_kernel.py``) and
``chip_smoke.py``'s phase 14 both hold it::

    sim, setup = compare_volume_em.cell_sim("corona99.evolve", "cuda")
    sim.run(setup)
    inputs = compare_volume_em.sums_inputs(sim, 1)[-1]
    c = compare_volume_em.compare(inputs)
    print(compare_volume_em.describe(c, "corona99"),
          compare_volume_em.departures(c))

The configurations are the benchmark cells' own, as its harness builds
them from ``benchmark/configs`` and ``benchmark/workloads``.
"""
from __future__ import annotations

import sys
from pathlib import Path
from typing import NamedTuple

import torch

from compton2d_tpu_torch.driver import Simulation
from compton2d_tpu_torch.physics import emissivity as em

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
# the ranks of corona99.ranks4, whose zone farm gives each rank a slice
RANKS = 4
SEED = 2 ** 31 + 3


def gap_limit(num_nt: int) -> float:
    """The most two orders of summing num_nt float32 terms can part, as a
    share of the sum of the terms' magnitudes: twice (num_nt - 1) units
    of the last place."""
    return 2.0 * (num_nt - 1) * 2.0 ** -24


class SumsInputs(NamedTuple):
    """``emissivity.sync_sums``'s arguments."""

    nu21: torch.Tensor    # (V,)
    gamma: torch.Tensor   # (N,)
    nu_b: torch.Tensor    # (Z, 1)
    face: torch.Tensor    # (Z, 1)
    fw: torch.Tensor      # (Z, N)
    sg: torch.Tensor      # (Z, N)


def cell_sim(cell: str, device, seed: int = SEED):
    """A Simulation of benchmark cell ``cell``'s configuration and
    traffic on one card, and the steps of its set-up."""
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    from harness import specs

    w = specs.load_workload(cell)
    cfg, zones = specs.sim_config(specs.load_config(w["config"]), w, seed)
    return Simulation(cfg, zones, device=device), int(w.get("setup_steps",
                                                            0))


def sums_inputs(sim, steps: int) -> list:
    """The inputs of ``emissivity.sync_sums`` in each of ``steps`` steps
    of ``sim``."""
    got = []
    sums = em.sync_sums

    def record(*a):
        got.append(SumsInputs(*a))
        return sums(*a)

    em.sync_sums = record
    try:
        for _ in range(steps):
            sim.step()
    finally:
        em.sync_sums = sums
    return got


def zone_part(x: SumsInputs, idx) -> SumsInputs:
    """The inputs of the zones ``idx`` alone."""
    idx = torch.as_tensor(idx, device=x.fw.device)
    return x._replace(nu_b=x.nu_b[idx], face=x.face[idx], fw=x.fw[idx],
                      sg=x.sg[idx])


def rank_zones(n_zones: int, rank: int, world: int = RANKS) -> list:
    """The zones of ``rank``'s slice under the zone farm
    (``parallel.mesh.zone_slice_flat``: ceil(Z / world) a rank, the last
    zone repeated into the pad)."""
    zs = -(-n_zones // world)
    return [min(z, n_zones - 1) for z in range(rank * zs, (rank + 1) * zs)]


def _terms(x: SumsInputs):
    """Chunks of t (zones, V, N) with their zone slice, as the plain
    version makes them."""
    Z, N = x.fw.shape
    chunk = max(1, em.ZONE_CHUNK_ELEMS // (x.nu21.shape[0] * N))
    for z0 in range(0, Z, chunk):
        zs = slice(z0, z0 + chunk)
        t = x.nu21[None, :, None] / (
            3.0 * (x.gamma * x.gamma)[None, None, :]
            * (x.nu_b[zs] / 1.0e21)[:, :, None])
        yield zs, t


def skipped_shares(x: SumsInputs):
    """The shares of (zone, photon bin, electron bin) terms the kernel
    skips, each exactly 0 in the plain version: those with t >= 1e4 or
    NaN, and those below 1e4 whose factor exp(-2 min(ts, 60)) underflows
    (on a card, torch.exp is the kernel's expf)."""
    big = under = 0
    for _, t in _terms(x):
        skip = ~(t < 1.0e4)
        w = torch.exp(-2.0 * torch.clamp_max(torch.clamp(t, 1e-12, 2.0e4),
                                             60.0))
        big += int(torch.count_nonzero(skip))
        under += int(torch.count_nonzero(~skip & (w == 0.0)))
    n = x.fw.numel() * x.nu21.shape[0]
    return big / n, under / n


def magnitudes(x: SumsInputs):
    """The sums of the terms' magnitudes, |face F(t) fw| and
    |face F(t) sg| over gamma, (Z, V) each, in float64."""
    js, ks = [], []
    for zs, t in _terms(x):
        es = torch.abs(x.face[zs, :, None] * em.sync_kernel_f32(t)).double()
        js.append(torch.sum(es * torch.abs(x.fw[zs, None, :]).double(), -1))
        ks.append(torch.sum(es * torch.abs(x.sg[zs, None, :]).double(), -1))
    return torch.cat(js), torch.cat(ks)


def _gap(a, b, scale) -> float:
    """The largest |a - b| over ``scale`` where both are finite (0 where
    both are 0); inf where they are not both NaN, or not the same
    infinity, elsewhere."""
    ok = torch.isfinite(a) & torch.isfinite(b)
    if not (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(a[torch.isinf(a) | torch.isinf(b)],
                            b[torch.isinf(a) | torch.isinf(b)])):
        return float("inf")
    d = torch.abs(a[ok].double() - b[ok].double())
    s = scale[ok]
    rel = torch.where(d > 0, d / torch.where(s > 0, s, 1e-300), 0.0)
    return float(rel.max()) if rel.numel() else 0.0


class Comparison(NamedTuple):
    j: torch.Tensor        # the kernel's sums
    k: torch.Tensor
    j_gap: float           # largest |kernel - plain| over the magnitudes
    k_gap: float
    limit: float           # gap_limit(num_nt)
    launches: int          # kernel launches of the kernel's sums
    skipped: tuple         # skipped_shares


def compare(x: SumsInputs) -> Comparison:
    """The sums by the kernel and by the plain version on the same CUDA
    inputs."""
    before = em.launch_counts()["volume_em"]
    jk, kk = em.sync_sums(*x)
    launches = em.launch_counts()["volume_em"] - before
    jp, kp = em.sync_sums_reference(*x)
    mj, mk = magnitudes(x)
    return Comparison(jk, kk, _gap(jk, jp, mj), _gap(kk, kp, mk),
                      gap_limit(x.fw.shape[1]), launches, skipped_shares(x))


def describe(c: Comparison, label: str) -> str:
    z, v = c.j.shape
    return (f"{label}: {z} zones x {v} photon bins; kernel against the "
            f"plain version: emission gap {c.j_gap:.3e}, absorption gap "
            f"{c.k_gap:.3e} of the terms' magnitudes (limit {c.limit:.3e}); "
            f"terms skipped: {100 * c.skipped[0]:.2f}% with t >= 1e4, "
            f"{100 * c.skipped[1]:.2f}% whose exp(-2 ts) underflows")


def departures(c: Comparison) -> list:
    """Where the kernel departs from the plain version: a gap beyond what
    the order of the sums allows, or other than one kernel launch."""
    out = []
    if not (c.j_gap <= c.limit and c.k_gap <= c.limit):
        out.append(f"gaps {c.j_gap:.3e}, {c.k_gap:.3e} over {c.limit:.3e}")
    if c.launches != 1:
        out.append(f"{c.launches} kernel launches")
    return out
