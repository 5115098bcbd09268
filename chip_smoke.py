"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card::

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. card and build: the card's name and power limit, the torch / CUDA
   versions, and the nvcc build of ``csrc/flight.cu`` for sm_90a;
2. the flight kernel in its inline-scatter mode against its plain
   PyTorch version on the card, at the main path's shapes (131072 slots,
   8x4 zones, 400 energy and 200 gamma bins) with inputs made by numpy
   from a seed: lane-for-lane agreement after one iteration, >= 99%
   identical lanes after 256, bitwise repeatability, and both times;
2b. the same for the kernel's strat mode (collisions freeze with
   FLAG_SCATTER), at the Mrk 421 shapes (131072 slots, 10x4 zones, 400
   energy and 200 gamma bins), with 512 iterations;
3. the main path: ``small_corona`` at the benchmark size with the FP
   solve on, 2 warm-up and 8 timed steps through ``Simulation.step()``,
   checking the kernel launches, device placement, the per-step energy
   audit, finite temperatures, escapes, repeatability from the seed, and
   statistical agreement with the plain (CPU) path on a small grid;
4. the Mrk 421 flare run at the width of the dense science run (10x4
   zones, 131072 slots, nst 200000, n_e 2e6, stratified splitting with
   gamma_c 3e4 and 64 copies) through ``run_to_stop`` to t_stop = 7e4 s
   with outputs attached, then the ``run_mrk421`` post-processing:
   every step's energy audit, strat-mode launches, frozen scatters and
   placed copies, the event file, the SED's peaks and its synchrotron
   hump's centre against the committed artifact's.

Each kernel's wrapper counts its launches; the counts are set to 0 just
before each main path and read just after. The line before the last is a
JSON summary of every kernel mode with its times and its roofline bound;
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from compton2d_tpu_torch import run_mrk421
from compton2d_tpu_torch.config import RunConfig
from compton2d_tpu_torch.examples import small_corona
from compton2d_tpu_torch.physics.electron_dist import gnt_grid
from compton2d_tpu_torch.tables import e_field_grid
from compton2d_tpu_torch.transport import flight, tracking

N_SLOTS, NZ, NR, N_VOL, NUM_NT = 1 << 17, 8, 4, 400, 200
MRK_NZ, MRK_NR = 10, 4       # the Mrk 421 grid
TIMED_STEPS, WARM_STEPS = 8, 2
AUDIT_TOL = 2e-3     # |balance - 1|, the JAX tests' bound
MRK_AUDIT_TOL = 5e-3  # the bound of tests/test_mrk421.py
MAX_TRIES = RunConfig().max_scatter_tries
# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# operations of one lane-iteration in each state of the flight kernel,
# counted from csrc/flight.cu (arithmetic, compares and the counter hash,
# a transcendental as one): FLY rounded down; SCT_A as its CDF scan
# alone; SCT_B as its sz candidate alone. Lower counts, so the bound
# stays a least time.
OPS_FLY, OPS_SCT_A, OPS_SCT_B = 200, 20, 40


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain version
# ---------------------------------------------------------------------------
def kernel_inputs(device, nz: int = NZ, nr: int = NR, seed: int = 0):
    """Random photons and zone tables at a main path's shapes."""
    rng = np.random.default_rng(seed)
    nzr = nz * nr
    e_ph = e_field_grid(N_VOL).astype(np.float32)
    gnt = gnt_grid(NUM_NT).astype(np.float32)
    # scattering opacity of a few per unit length with a KN-like cutoff,
    # weak absorption rising toward low energies
    sig = rng.uniform(1.0, 10.0, (nzr, 1)) / (1.0 + e_ph[None, :] / 511.0)
    kap = rng.uniform(0.0, 0.05, (nzr, 1)) * np.minimum(
        1.0, (e_ph[None, :] / 1e-3) ** -1.5)
    theta = rng.uniform(0.05, 0.4, (nzr, 1))
    g = gnt[None, :] + 1.0
    pdf = g * g * np.sqrt(1.0 - 1.0 / (g * g)) * np.exp(-gnt[None, :] / theta)
    cdf = np.concatenate(
        [np.zeros((nzr, 1)), np.cumsum(pdf[:, :-1] * np.diff(gnt), axis=1)],
        axis=1)
    cdf = (cdf / cdf[:, -1:]).astype(np.float32)
    r_edges = np.linspace(0.0, 1.0, nr + 1).astype(np.float32)
    z_edges = np.linspace(0.0, 1.0, nz + 1).astype(np.float32)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    tables = flight.build_flight_tables(
        t(np.stack([sig, kap], axis=-1)), t(cdf), t(gnt), t(r_edges),
        t(z_edges), float(np.log(e_ph[0])), float(np.log(e_ph[1] / e_ph[0])),
    )
    n = N_SLOTS
    jz = rng.integers(0, nz, n)
    kr = rng.integers(0, nr, n)
    r = r_edges[kr] + rng.uniform(0.01, 0.99, n) * (1.0 / nr)
    z = z_edges[jz] + rng.uniform(0.01, 0.99, n) * (1.0 / nz)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    w = rng.uniform(0.5, 1.5, n)
    photons = dict(
        e=t(10.0 ** rng.uniform(-3.0, 2.0, n)), w=t(w), w0=t(w), r=t(r),
        z=t(z), mu=t(rng.uniform(-1.0, 1.0, n)), cphi=t(np.cos(phi)),
        sphi=t(np.sin(phi)), dcen=t(rng.uniform(0.01, 0.5, n)),
        jz=t(jz, torch.int32), kr=t(kr, torch.int32),
        alive=t(rng.uniform(size=n) < 0.9, torch.bool),
    )
    seeds = t(rng.integers(-2**31, 2**31, n // flight.TILE), torch.int32)
    return photons, tables, seeds


INT_FIELDS = ("jz", "kr", "alive", "mode", "flag", "jn", "kn", "sct_cnt")
LANE_FLOATS = ("e", "w", "r", "z", "mu", "cphi", "sphi", "dcen")


def run_flight(fn, photons, tables, seeds, max_iters, nz=NZ, nr=NR,
               inline=True, **kw):
    p = photons
    return fn(p["e"], p["w"], p["w0"], p["r"], p["z"], p["mu"], p["cphi"],
              p["sphi"], p["dcen"], p["jz"], p["kr"], p["alive"], tables,
              seeds, nz=nz, nr=nr, weight_floor=1e-10, max_iters=max_iters,
              max_tries=MAX_TRIES, inline_scatter=inline, **kw)


def flight_bound(photons, tables, res, nz: int, nr: int) -> dict:
    """The least time of one flight-kernel entry on these inputs: the
    larger of its bytes (each input read once, each output, log and tally
    written once; the strat mode writes no logs) over the HBM rate and its
    operations over the float32 rate. The operations are the lower counts
    above times the least lane-iterations that the kernel's result
    ``res`` shows: one flight per live lane and one more per scatter, and
    one SCT_A and one SCT_B iteration per scatter."""
    n = photons["e"].shape[0]
    nzr = nz * nr
    table_elems = sum(t.numel() for t in (
        tables.sig, tables.kap, tables.cdf, tables.guide, tables.gm1,
        tables.r_edges, tables.z_edges))
    bytes_in = 4 * (12 * n + n // flight.TILE + table_elems)
    bytes_out = 4 * (20 * n + 2 * nzr) + 8 * res.iglog.numel()
    live = photons["alive"] & (photons["dcen"] > 0.0)
    scatters = int(res.sct_cnt[live].sum())
    ops = (OPS_FLY * (int(live.sum()) + scatters)
           + (OPS_SCT_A + OPS_SCT_B) * scatters)
    t_bytes = (bytes_in + bytes_out) / PEAK_BYTES_S
    t_ops = ops / PEAK_F32_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_in + bytes_out, "ops": ops}


def outputs_equal(a, b) -> bool:
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            if not torch.equal(x, y):
                return False
        elif x != y:
            return False
    return True


def assert_sums_close(k, p, tol: float, e_scale: float, label: str):
    """Tallies and energy sums of kernel ``k`` against plain ``p``. The two
    add in different orders, so each is held to ``tol`` of its natural
    scale: the input energy for the energy sums, each zone's edep for
    edep, and c x edep for prdep, a signed sum of terms up to
    c x (absorbed energy) that cancels to a much smaller net value."""
    ed_k, ed_p = k.tally[0], p.tally[0]
    torch.testing.assert_close(
        ed_k, ed_p, rtol=tol, atol=tol * float(torch.max(torch.abs(ed_p))),
        msg=lambda m: f"{label} edep: {m}")
    c_light = float(np.float32(2.9979245620e10))
    err = torch.abs(k.tally[1] - p.tally[1])
    bound = tol * (c_light * torch.abs(ed_p) + torch.abs(p.tally[1]))
    if bool(torch.any(err > bound)):
        raise AssertionError(f"{label} prdep: max error {float(err.max())}"
                             f" over bound {float(bound.min())}")
    for f in ("ekill", "esct", "epair"):
        torch.testing.assert_close(getattr(k, f), getattr(p, f), rtol=tol,
                                   atol=tol * e_scale,
                                   msg=lambda m, f=f: f"{label} {f}: {m}")


def phase_kernel(device, label: str, nz: int, nr: int, inline: bool,
                 max_iters: int) -> dict:
    """One kernel mode against its plain version at (nz, nr) zones."""
    photons, tables, seeds = kernel_inputs(device, nz, nr)
    e_scale = float(torch.sum(photons["w"]))   # total input energy
    kw = dict(nz=nz, nr=nr, inline=inline)

    # (a) one iteration: integers exact, floats rtol 1e-5 (atol 1e-6 for
    # values near zero); tallies and sums to 1e-5 of their scale
    # (assert_sums_close)
    k = run_flight(flight.flight_step, photons, tables, seeds, 1, **kw)
    p = run_flight(flight.flight_step_reference, photons, tables, seeds, 1,
                   **kw)
    torch.cuda.synchronize()
    logs = ("iglog", "delog") if inline else ()
    for f in INT_FIELDS + logs[:1]:
        if not torch.equal(getattr(k, f).to(torch.int64),
                           getattr(p, f).to(torch.int64)):
            bad = int((getattr(k, f) != getattr(p, f)).sum())
            raise AssertionError(f"{label} (a) {f}: {bad} lanes differ")
    if k.it_used != p.it_used:
        raise AssertionError(f"{label} (a) it_used {k.it_used} != "
                             f"{p.it_used}")
    max_abs = 0.0
    for f in LANE_FLOATS + logs[1:]:
        a, b = getattr(k, f), getattr(p, f)
        torch.testing.assert_close(
            a, b, rtol=1e-5, atol=1e-6,
            msg=lambda m, f=f: f"{label} (a) {f}: {m}")
        max_abs = max(max_abs, float(torch.max(torch.abs(a - b))))
    assert_sums_close(k, p, 1e-5, e_scale, f"{label} (a)")
    n_sct = int((k.flag == flight.FLAG_SCATTER).sum())
    if not inline and n_sct == 0:
        raise AssertionError(f"{label} (a) no lane froze with FLAG_SCATTER")
    log(f"{label} (a) max_iters=1: integers exact ({n_sct} FLAG_SCATTER "
        f"lanes), max |float diff| = {max_abs:.3e}")

    # (b) the path's budget: >= 99% of lanes with identical integer
    # state; tallies and sums to 1e-3 of their scale
    k = run_flight(flight.flight_step, photons, tables, seeds, max_iters,
                   **kw)
    p = run_flight(flight.flight_step_reference, photons, tables, seeds,
                   max_iters, **kw)
    torch.cuda.synchronize()
    same = torch.ones(N_SLOTS, dtype=torch.bool, device=device)
    for f in INT_FIELDS:
        same &= getattr(k, f).to(torch.int64) == getattr(p, f).to(torch.int64)
    frac = float(same.float().mean())
    if frac < 0.99:
        raise AssertionError(f"{label} (b) identical lanes {frac:.5f} < 0.99")
    assert_sums_close(k, p, 1e-3, e_scale, f"{label} (b)")
    log(f"{label} (b) max_iters={max_iters}: identical lanes {frac:.6f}, "
        f"it_used kernel {k.it_used} plain {p.it_used}, scatters/lane "
        f"{float(k.sct_cnt.float().mean()):.3f}, FLAG_SCATTER lanes "
        f"{int((k.flag == flight.FLAG_SCATTER).sum())}")

    # (c) repeatability: a second launch is bitwise equal
    k2 = run_flight(flight.flight_step, photons, tables, seeds, max_iters,
                    **kw)
    torch.cuda.synchronize()
    if not outputs_equal(k, k2):
        raise AssertionError(f"{label} (c) two kernel launches differ")
    log(f"{label} (c) two launches bitwise equal")

    # (d) times at the path's budget: medians after a warm-up, each call
    # synchronised (the wrapper included)
    def timed(fn, reps):
        run_flight(fn, photons, tables, seeds, max_iters, **kw)
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_flight(fn, photons, tables, seeds, max_iters, **kw)
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(ts)

    plain_ms = timed(flight.flight_step_reference, 3)
    ms = timed(flight.flight_step, 20)
    bound = flight_bound(photons, tables, k, nz, nr)
    log(f"{label} (d) kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms "
        f"(median, {N_SLOTS} slots, {nz}x{nr} zones, max_iters="
        f"{max_iters}); bound {bound['bound_ms']:.6f} ms by "
        f"{bound['bound_by']} ({bound['bytes']} bytes, {bound['ops']} "
        f"operations)")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------
def state_devices(state) -> set:
    devs = set()

    def walk(obj):
        if isinstance(obj, torch.Tensor):
            devs.add(obj.device.type)
        elif isinstance(obj, torch.Generator):
            devs.add(obj.device.type)
        elif hasattr(obj, "_fields"):
            for name in obj._fields:
                walk(getattr(obj, name))

    walk(state)
    return devs


def bench_sim(device, seed: int = 0):
    return small_corona(nz=NZ, nr=NR, nst=60000, n_slots=N_SLOTS,
                        num_nt=NUM_NT, n_vol=N_VOL, nphfield=400,
                        t_const=False, max_flight_iters=256, seed=seed,
                        device=device)


def small_audit(device, seed: int):
    sim = small_corona(nz=3, nr=2, nst=3000, n_slots=4096, num_nt=50,
                       n_vol=64, nphfield=64, t_const=False, seed=seed,
                       device=device)
    sim.run(2)
    return sim.energy_audit()


def phase_main_path(device, card: str) -> int:
    sim = bench_sim(device)
    outs = []
    flight.LAUNCHES = flight.STRAT_LAUNCHES = 0
    for _ in range(WARM_STEPS):
        outs.append(sim.step())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        outs.append(sim.step())
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = flight.LAUNCHES
    if launches <= 0:
        raise AssertionError("the main path launched no flight kernel")
    if flight.STRAT_LAUNCHES:
        raise AssertionError("small_corona launched the strat mode")
    log(f"main path: {launches} flight kernel launches in "
        f"{WARM_STEPS + TIMED_STEPS} steps")

    devs = state_devices(sim.state)
    if devs != {"cuda"}:
        raise AssertionError(f"state tensors on {devs}, expected cuda only")
    for i, out in enumerate(outs):
        sim.last_outputs = out
        a = sim.energy_audit()
        if not abs(a["balance"] - 1.0) < AUDIT_TOL:
            raise AssertionError(f"step {i}: audit balance {a['balance']}")
        log(f"step {i}: balance {a['balance']:.7f} escaped "
            f"{a['escaped']:.4e} erg census {a['census']:.4e} erg "
            f"fp_incomplete {int(out.fp_incomplete)} rounds "
            f"{int(out.tallies.trk_rounds)} sct_overflow "
            f"{int(out.tallies.n_sct_overflow)}")
        if not a["escaped"] > 0.0:
            raise AssertionError(f"step {i}: nothing escaped")
    tea = sim.state.zones.tea
    if not bool(torch.all(torch.isfinite(tea))):
        raise AssertionError("non-finite zone temperatures")
    log(f"zone Te [keV]: min {float(tea.min()):.3f} max "
        f"{float(tea.max()):.3f}; {sim.summary()}")

    timed = outs[WARM_STEPS:]
    histories = sum(int(o.n_tracked) for o in timed)
    rounds = sum(int(o.tallies.trk_rounds) for o in timed) / TIMED_STEPS
    ms_step = 1e3 * elapsed / TIMED_STEPS
    log(f"main path on {card}: {ms_step:.3f} ms/step, "
        f"{histories / elapsed:.6e} histories/s, {rounds:.2f} tracking "
        f"rounds/step ({TIMED_STEPS} timed steps after {WARM_STEPS} warm-up)")

    # repeatability: a second run from the same seed gives bitwise-equal
    # tallies
    sim2 = bench_sim(device)
    for i in range(3):
        o2 = sim2.step()
        for f in o2.tallies._fields:
            if not torch.equal(getattr(o2.tallies, f),
                               getattr(outs[i].tallies, f)):
                raise AssertionError(f"step {i}: tally {f} not repeatable")
    log("main path: tallies bitwise repeatable from the seed (3 steps)")

    # agreement with the plain path (CPU) on a small grid; nst=3000
    # seed-to-seed spread is ~30% on these totals, so this catches wiring
    # faults, as the reference's own kernel-vs-XLA driver test does
    a_gpu = small_audit(device, seed=6)
    a_cpu = small_audit("cpu", seed=6)
    for q in ("escaped", "census"):
        rel = abs(a_gpu[q] - a_cpu[q]) / max(abs(a_cpu[q]), 1e-300)
        log(f"small grid {q}: card {a_gpu[q]:.4e} plain {a_cpu[q]:.4e} "
            f"rel {rel:.3f}")
        if not rel < 0.6:
            raise AssertionError(f"small grid {q} differs by {rel:.3f}")
    for a in (a_gpu, a_cpu):
        if not abs(a["balance"] - 1.0) < AUDIT_TOL:
            raise AssertionError(f"small grid audit {a['balance']}")
    return launches


# ---------------------------------------------------------------------------
# phase 4: the Mrk 421 flare run
# ---------------------------------------------------------------------------
MRK_ARGS = ["--nst", "200000", "--n-slots", "131072", "--n-e", "2e6",
            "--strat-gamma-c", "3e4", "--strat-copies", "64"]
ARTIFACT = os.path.join("artifacts", "mrk421_dense", "summary.json")
ARTIFACT_SED = os.path.join("artifacts", "mrk421_dense", "sed.dat")
# the synchrotron hump's centre (run_mrk421.sync_centroid_kev) against the
# committed artifact's: within this factor. Eight CPU runs of port and
# reference at a quarter of nst (tests/compare_mrk421.py) spread over
# 0.80-1.40 of the artifact's centre, eight seeds of the port at full
# width on an H100 (compton2d_tpu_torch/mrk421_seeds.py) over 1.05-1.38
CENTROID_FACTOR = 1.5


def phase_mrk421(device, card: str) -> int:
    args = run_mrk421.parser().parse_args(
        MRK_ARGS + ["--device", str(device)])
    counts = {"frozen": 0, "copies": 0, "calls": 0}
    apply_scatter = tracking.apply_scatter

    def counted(ph, tl, sct, *rest):
        # frozen scatters in, placed copies out (slots that came alive)
        ph2, tl2 = apply_scatter(ph, tl, sct, *rest)
        counts["calls"] += 1
        counts["frozen"] += int(sct.sum())
        counts["copies"] += int(ph2.alive.sum()) - int(ph.alive.sum())
        return ph2, tl2

    with tempfile.TemporaryDirectory() as out_dir:
        args.out = out_dir
        sim = run_mrk421.make_sim(args)
        sim.attach_outputs(out_dir, event_file="evb.dat")
        outs, audits = [], []
        step = sim.step

        def audited_step():
            out = step()
            outs.append(out)
            audits.append(sim.energy_audit())
            return out

        sim.step = audited_step
        tracking.apply_scatter = counted
        flight.LAUNCHES = flight.STRAT_LAUNCHES = 0
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            done = sim.run_to_stop()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            tracking.apply_scatter = apply_scatter
        launches = flight.STRAT_LAUNCHES
        if not done:
            raise AssertionError("run_to_stop did not reach t_stop")
        if launches <= 0 or flight.LAUNCHES:
            raise AssertionError(f"strat launches {launches}, inline "
                                 f"launches {flight.LAUNCHES}")
        if counts["frozen"] <= 0 or counts["copies"] <= 0:
            raise AssertionError(f"scatter counts {counts}")
        devs = state_devices(sim.state)
        if devs != {"cuda"}:
            raise AssertionError(f"state tensors on {devs}, expected cuda")
        for i, (out, a) in enumerate(zip(outs, audits)):
            log(f"mrk421 step {i}: balance {a['balance']:.7f} escaped "
                f"{a['escaped']:.4e} erg rounds "
                f"{int(out.tallies.trk_rounds)} events "
                f"{int(out.events.count[0])}")
            if not abs(a["balance"] - 1.0) < MRK_AUDIT_TOL:
                raise AssertionError(f"mrk421 step {i}: audit balance "
                                     f"{a['balance']}")
        events = np.loadtxt(os.path.join(out_dir, "evb.dat")).reshape(-1, 7)
        if events.shape[0] <= 10000:
            raise AssertionError(f"{events.shape[0]} event records")
        for name in ("spectrum.dat", "photons.dat", "temp_profile.dat",
                     "lc_mu00.dat"):
            if not os.path.getsize(os.path.join(out_dir, name)):
                raise AssertionError(f"{name} is empty")
        peaks = run_mrk421.postprocess(events, sim.cfg.grid.r_max, out_dir)
        centre = run_mrk421.sync_centroid_kev(
            np.loadtxt(os.path.join(out_dir, "sed.dat")))

    sync, ssc = peaks["sync_peak_keV_obs"], peaks["ssc_peak_keV_obs"]
    if sync is None or not 0.05 < sync < 50.0:
        raise AssertionError(f"sync peak {sync} keV outside 0.05-50")
    if ssc is None or not ssc > 1e6:
        raise AssertionError(f"SSC peak {ssc} keV not above 1e6")
    if not peaks["tev_band_records_all_mu"] > 0:
        raise AssertionError("no TeV-band records")
    ref_centre = run_mrk421.sync_centroid_kev(np.loadtxt(ARTIFACT_SED))
    if not abs(np.log(centre / ref_centre)) < np.log(CENTROID_FACTOR):
        raise AssertionError(f"sync hump centre {centre:.4g} keV, artifact "
                             f"{ref_centre:.4g} keV")
    steps = len(outs)
    histories = sum(int(o.n_tracked) for o in outs)
    rounds = sum(int(o.tallies.trk_rounds) for o in outs) / steps
    with open(ARTIFACT) as fh:
        ref = json.load(fh)
    log(f"mrk421 on {card}: {1e3 * wall / steps:.3f} ms/step, "
        f"{histories / wall:.6e} histories/s, {rounds:.2f} rounds/step, "
        f"wall {wall:.3f} s, {launches} strat-mode launches, "
        f"{counts['frozen']} frozen scatters, {counts['copies']} placed "
        f"copies in {counts['calls']} apply_scatter calls; port vs "
        f"committed artifact: steps {steps} vs {ref['steps']}, records "
        f"{events.shape[0]} vs {ref['n_event_records']}, balance "
        f"{audits[-1]['balance']:.7f} vs {ref['balance']:.7f}, sync peak "
        f"{sync:.4g} vs {ref['sync_peak_keV_obs']:.4g} keV, sync hump "
        f"centre {centre:.4g} vs {ref_centre:.4g} keV, SSC peak "
        f"{ssc:.4g} vs {ref['ssc_peak_keV_obs']:.4g} keV, TeV all-mu "
        f"records {peaks['tev_band_records_all_mu']} vs "
        f"{ref['tev_band_records_all_mu']}, >100 GeV all-mu records "
        f"{peaks['gev100_records_all_mu']} vs "
        f"{ref['gev100_records_all_mu']}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    log(card)   # name, power limit: nvidia-smi's own line
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    build_s = flight.build()
    log(f"built {flight.library_path().name} in {build_s:.2f} s")

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    k_inline = phase_kernel(device, "kernel", NZ, NR, True, 256)
    k_strat = phase_kernel(device, "strat kernel", MRK_NZ, MRK_NR, False,
                           512)
    launches_inline = phase_main_path(device, card)
    launches_strat = phase_mrk421(device, card)

    replaces = "compton2d_tpu/transport/flight_pallas2.py:347"
    log(json.dumps({"kernels": [
        {"name": "flight_kernel", "route": "cuda",
         "source": "compton2d_tpu_torch/csrc/flight.cu",
         "replaces": replaces, "launches": launches_inline,
         "library_ms": None, **k_inline},
        {"name": "flight_kernel_strat", "route": "cuda",
         "source": "compton2d_tpu_torch/csrc/flight.cu",
         "replaces": replaces, "launches": launches_strat,
         "library_ms": None, **k_strat},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
