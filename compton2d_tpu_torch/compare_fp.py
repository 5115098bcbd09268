"""The FP substep kernel (``csrc/fp_substeps.cu``) against its plain
PyTorch version (``fp.update.substep_loop_reference``) on the same
``fp_step`` inputs, as the card tests (``tests/test_torch_fp_kernel.py``)
and ``chip_smoke.py``'s phase 13 both hold it::

    sim, setup = compare_fp.cell_sim("mrk421", "cuda")
    sim.run(setup)
    args, kw = compare_fp.fp_args(sim, 1)[-1]
    c = compare_fp.compare(args, kw)
    print(compare_fp.describe(c, "mrk421"), compare_fp.departures(c))

The two configurations are those of the benchmark's cells, as the port
builds them (``profile_phases.make_sim``): ``mrk421``, the dense Mrk 421
run from t = 0, and ``large_corona``, the 99x99 corona after the cell's 4
set-up steps.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from compton2d_tpu_torch import driver, profile_phases
from compton2d_tpu_torch.fp import update

# the kernel against the plain loop, on tea and f_nt as the benchmark's
# check measures them: a tenth of its tightest per-step limit
GAP = 2e-6
# configuration -> its set-up steps
CELLS = {"mrk421": 0, "large_corona": 4}


def cell_sim(name: str, device):
    """A Simulation of the cell configuration ``name`` (``CELLS``) and
    the steps of its set-up."""
    return profile_phases.make_sim(name, device), CELLS[name]


def fp_args(sim, steps: int) -> list:
    """The (args, kwargs) of ``driver.fp_step`` in each of ``steps`` steps
    of ``sim``."""
    got = []
    fp_step = driver.fp_step

    def record(*a, **k):
        got.append((a, k))
        return fp_step(*a, **k)

    driver.fp_step = record
    try:
        for _ in range(steps):
            sim.step()
    finally:
        driver.fp_step = fp_step
    return got


def solve(args, kw, loop=None):
    """``fp_step`` on (args, kw) with its substep loop ``loop`` (the
    module's own by default): its result, the loop's result and the
    loop's inputs."""
    got = {}
    run = loop or update.substep_loop

    def record(lp):
        got["lp"] = lp
        got["sub"] = run(lp)
        return got["sub"]

    keep = update.substep_loop
    update.substep_loop = record
    try:
        res = update.fp_step(*args, **kw)
    finally:
        update.substep_loop = keep
    return res, got["sub"], got["lp"]


class Comparison(NamedTuple):
    kernel: update.FPResult
    plain: update.FPResult
    count: torch.Tensor    # (Z,) the plain loop's per-zone substeps
    flips: list            # [(zone, kernel's count, plain loop's count)]
    te: float              # largest relative gap of tea
    f_nt: float            # largest L1 gap of a zone's f_nt, relative
    launches: int          # kernel launches of the kernel's fp_step
    loop: update.Loop      # the substep loop's inputs


def compare(args, kw) -> Comparison:
    """``fp_step`` with the kernel and with the plain loop on the same
    CUDA inputs."""
    before = update.launch_counts()["fp_substeps"]
    rk, sk, lp = solve(args, kw)
    launches = update.launch_counts()["fp_substeps"] - before
    rp, sp, _ = solve(args, kw, update.substep_loop_reference)
    flips = [(z, int(sk.count[z]), int(sp.count[z])) for z in
             torch.nonzero(sk.count != sp.count).flatten().tolist()]
    tp = rp.zones.tea.double()
    te = float(torch.max(torch.abs(rk.zones.tea.double() - tp) / tp))
    num_nt = rp.zones.f_nt.shape[-1]
    fk = rk.zones.f_nt.double().reshape(-1, num_nt)
    fp = rp.zones.f_nt.double().reshape(-1, num_nt)
    fnt = float(torch.max(torch.sum(torch.abs(fk - fp), -1) / torch.clamp_min(
        torch.sum(torch.abs(fp), -1), 1e-300)))
    return Comparison(rk, rp, sp.count, flips, te, fnt, launches, lp)


def describe(c: Comparison, label: str) -> str:
    count = c.count
    return (f"{label}: substeps {int(c.plain.substeps)} (zones "
            f"{int(count.min())}-{int(count.max())}, sum {int(count.sum())})"
            f", incomplete {int(c.plain.incomplete)}; kernel against the "
            f"plain loop: tea gap {c.te:.3e}, f_nt gap {c.f_nt:.3e}, zones "
            f"whose counts differ (zone, kernel, plain) {c.flips[:20]}")


def departures(c: Comparison) -> list:
    """Where the kernel departs from the plain loop: a zone's substep
    count (a flipped floor, last-substep or injection decision), the
    step's substeps or incomplete zones, tea or f_nt beyond GAP, or other
    than one kernel launch."""
    out = []
    if c.flips:
        out.append(f"{len(c.flips)} zones' substep counts differ")
    if not (int(c.kernel.substeps) == int(c.plain.substeps)
            == int(c.count.max())):
        out.append(f"substeps {int(c.kernel.substeps)} against "
                   f"{int(c.plain.substeps)}")
    if int(c.kernel.incomplete) != int(c.plain.incomplete):
        out.append(f"incomplete {int(c.kernel.incomplete)} against "
                   f"{int(c.plain.incomplete)}")
    if not (c.te <= GAP and c.f_nt <= GAP):
        out.append(f"tea gap {c.te:.3e}, f_nt gap {c.f_nt:.3e} over {GAP}")
    if c.launches != 1:
        out.append(f"{c.launches} kernel launches")
    return out
