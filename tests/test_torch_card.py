"""The flight kernel, in its inline-scatter and strat modes, with and
without pair_switch, in its windowed mode above 1024 zones, with its
tables in shared and in global memory, and over several blocks that end
inside a tile, against its plain PyTorch version on a CUDA card; its
SIMT counters against the plain version's lane-iterations; and one step
of each reference-format deck (boundary reflection, a flare and adaptive
dt; a file-lit blazar blob) on the card against the CPU plain path.

These tests need the card and skip without one. They import neither jax
nor the JAX package, so they also run on a machine without jax:

    python3 -m pytest --noconftest tests/test_torch_card.py -q
"""
import numpy as np
import pytest
import torch

from compton2d_tpu_torch.physics.electron_dist import gnt_grid
from compton2d_tpu_torch.tables import e_field_grid, e_gg_grid
from compton2d_tpu_torch.state import PhotonArray
from compton2d_tpu_torch.transport import flight, population

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda

NZ, NR, N, N_VOL, NUM_NT, N_GG = 4, 3, 4 * flight.TILE, 64, 50, 32
FIELDS = ("e", "w", "w0", "r", "z", "mu", "cphi", "sphi", "dcen", "jz",
          "kr", "alive")
INTS = ("jz", "kr", "alive", "mode", "flag", "jn", "kn", "sct_cnt")
FLOATS = ("e", "w", "r", "z", "mu", "cphi", "sphi", "dcen")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(dev, seed=0, pairs=False, nz=NZ, nr=NR):
    rng = np.random.default_rng(seed)
    nzr = nz * nr
    e_ph = e_field_grid(N_VOL).astype(np.float32)
    gnt = gnt_grid(NUM_NT).astype(np.float32)
    opac = np.stack([
        rng.uniform(2.0, 8.0, (nzr, 1)) * np.ones((1, N_VOL)),
        rng.uniform(0.0, 0.1, (nzr, 1)) * np.ones((1, N_VOL)),
    ], axis=-1)
    pdf = np.exp(-gnt[None, :] / rng.uniform(0.05, 0.4, (nzr, 1)))
    cdf = np.cumsum(pdf, axis=1) / pdf.sum(axis=1, keepdims=True)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    e_gg = e_gg_grid(N_GG).astype(np.float32)
    kgg = rng.uniform(0.5, 3.0, (nzr, 1)) * np.linspace(0.1, 1.0, N_GG)
    tables = flight.build_flight_tables(
        t(opac), t(cdf), t(gnt), t(np.linspace(0, 1, nr + 1)),
        t(np.linspace(0, 1, nz + 1)), float(np.log(e_ph[0])),
        float(np.log(e_ph[1] / e_ph[0])),
        u_edges=torch.as_tensor(flight.guide_u_edges(), device=dev),
        kgg_zone=t(kgg),
        e_gg_log0=float(np.log(e_gg[0])),
        e_gg_dlog=float(np.log(e_gg[1] / e_gg[0])))
    jz, kr = rng.integers(0, nz, N), rng.integers(0, nr, N)
    # pairs: 10 keV to 10 MeV, across the e_gg grid and 47 keV
    log_e = rng.uniform(1, 4, N) if pairs else rng.uniform(-2, 2, N)
    phi = rng.uniform(0, 2 * np.pi, N)
    ph = dict(
        e=t(10.0 ** log_e), w=t(np.ones(N)),
        w0=t(np.ones(N)), r=t((kr + rng.uniform(0.01, 0.99, N)) / nr),
        z=t((jz + rng.uniform(0.01, 0.99, N)) / nz),
        mu=t(rng.uniform(-1, 1, N)), cphi=t(np.cos(phi)),
        sphi=t(np.sin(phi)), dcen=t(rng.uniform(0.05, 0.5, N)),
        jz=t(jz, torch.int32), kr=t(kr, torch.int32),
        alive=t(rng.uniform(size=N) < 0.9, torch.bool))
    seeds = t(rng.integers(-2**31, 2**31, N // flight.TILE), torch.int32)
    return [ph[k] for k in FIELDS], tables, seeds


def _run(fn, args, tables, seeds, max_iters, inline=True, pairs=False,
         nz=NZ, nr=NR):
    return fn(*args, tables, seeds, nz=nz, nr=nr, weight_floor=1e-10,
              max_iters=max_iters, max_tries=64, inline_scatter=inline,
              pair_switch=pairs)


def test_kernel_one_iteration_lane_for_lane(card):
    """Integers exact; floats rtol 1e-5, atol 1e-6 (last-bit differences
    between the kernel's math and torch's CUDA ops)."""
    args, tables, seeds = _inputs(card)
    before = flight.LAUNCHES
    k = _run(flight.flight_step, args, tables, seeds, 1)
    assert flight.LAUNCHES == before + 1
    p = _run(flight.flight_step_reference, args, tables, seeds, 1)
    for name in INTS:
        assert torch.equal(getattr(k, name).long(),
                           getattr(p, name).long()), name
    for name in FLOATS:
        torch.testing.assert_close(getattr(k, name), getattr(p, name),
                                   rtol=1e-5, atol=1e-6)


def test_kernel_many_iterations_and_repeatable(card):
    """64 iterations: >= 99% of lanes with identical integer state, and
    two launches bitwise equal."""
    args, tables, seeds = _inputs(card, seed=1)
    k = _run(flight.flight_step, args, tables, seeds, 64)
    p = _run(flight.flight_step_reference, args, tables, seeds, 64)
    same = torch.ones(N, dtype=torch.bool, device=card)
    for name in INTS:
        same &= getattr(k, name).long() == getattr(p, name).long()
    assert float(same.float().mean()) >= 0.99
    assert float(k.sct_cnt.float().mean()) > 0.5
    k2 = _run(flight.flight_step, args, tables, seeds, 64)
    for a, b in zip(k, k2):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_strat_mode_lane_for_lane_and_repeatable(card):
    """inline_scatter=False: collisions freeze with FLAG_SCATTER. One
    iteration integers exact; 64 iterations >= 99% identical lanes with
    every frozen lane of the plain version frozen in the kernel too; two
    launches bitwise equal; the strat-mode launch count rises."""
    args, tables, seeds = _inputs(card, seed=2)
    before = flight.STRAT_LAUNCHES
    k = _run(flight.flight_step, args, tables, seeds, 1, inline=False)
    assert flight.STRAT_LAUNCHES == before + 1
    assert k.iglog.shape[0] == k.delog.shape[0] == 0   # nothing logged
    p = _run(flight.flight_step_reference, args, tables, seeds, 1,
             inline=False)
    for name in INTS:
        assert torch.equal(getattr(k, name).long(),
                           getattr(p, name).long()), name
    k = _run(flight.flight_step, args, tables, seeds, 64, inline=False)
    p = _run(flight.flight_step_reference, args, tables, seeds, 64,
             inline=False)
    same = torch.ones(N, dtype=torch.bool, device=card)
    for name in INTS:
        same &= getattr(k, name).long() == getattr(p, name).long()
    assert float(same.float().mean()) >= 0.99
    frozen = p.flag == flight.FLAG_SCATTER
    assert int(frozen.sum()) > 0 and int(k.sct_cnt.sum()) == 0
    assert float((k.flag[frozen] == flight.FLAG_SCATTER).float().mean()) \
        >= 0.99
    k2 = _run(flight.flight_step, args, tables, seeds, 64, inline=False)
    for a, b in zip(k, k2):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


@pytest.mark.parametrize("inline", [True, False])
def test_pair_mode_lane_for_lane_and_repeatable(card, inline):
    """pair_switch=True in both scatter modes: one iteration integers
    exact and floats rtol 1e-5; 64 iterations >= 99% identical lanes and
    epair within 1e-3 of the input energy; two launches bitwise equal; the
    pair-mode launch count rises with every launch."""
    args, tables, seeds = _inputs(card, seed=3, pairs=True)
    before = flight.PAIR_LAUNCHES
    k = _run(flight.flight_step, args, tables, seeds, 1, inline, True)
    assert flight.PAIR_LAUNCHES == before + 1
    p = _run(flight.flight_step_reference, args, tables, seeds, 1, inline,
             True)
    for name in INTS:
        assert torch.equal(getattr(k, name).long(),
                           getattr(p, name).long()), name
    for name in FLOATS:
        torch.testing.assert_close(getattr(k, name), getattr(p, name),
                                   rtol=1e-5, atol=1e-6)
    k = _run(flight.flight_step, args, tables, seeds, 64, inline, True)
    p = _run(flight.flight_step_reference, args, tables, seeds, 64, inline,
             True)
    same = torch.ones(N, dtype=torch.bool, device=card)
    for name in INTS:
        same &= getattr(k, name).long() == getattr(p, name).long()
    assert float(same.float().mean()) >= 0.99
    assert float(p.epair) > 0.01 * N
    torch.testing.assert_close(k.epair, p.epair, rtol=1e-3, atol=1e-3 * N)
    k2 = _run(flight.flight_step, args, tables, seeds, 64, inline, True)
    for a, b in zip(k, k2):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


@pytest.mark.parametrize("inline", [True, False])
def test_windowed_mode_lane_for_lane_and_repeatable(card, inline):
    """40x30 zones (above 1024), 4 zone-sorted tiles, win_z = 128: one
    iteration integers exact, FLAG_WINDOW lanes included, and floats rtol
    1e-5; 64 iterations >= 99% identical lanes and edep within 1e-3 of
    its largest zone; two launches bitwise equal; the windowed launch
    count rises with every launch."""
    nz, nr = 40, 30
    win_z = flight.window_z(nz, nr)
    assert win_z == flight.WIN_Z
    args, tables, seeds = _inputs(card, seed=4, nz=nz, nr=nr)
    args = list(population.zone_sort(PhotonArray(*args), nz, nr, win_z))
    kw = dict(inline=inline, nz=nz, nr=nr)
    before = flight.WINDOW_LAUNCHES
    k = _run(flight.flight_step, args, tables, seeds, 1, **kw)
    assert flight.WINDOW_LAUNCHES == before + 1
    p = _run(flight.flight_step_reference, args, tables, seeds, 1, **kw)
    for name in INTS:
        assert torch.equal(getattr(k, name).long(),
                           getattr(p, name).long()), name
    for name in FLOATS:
        torch.testing.assert_close(getattr(k, name), getattr(p, name),
                                   rtol=1e-5, atol=1e-6)
    assert int((k.flag == flight.FLAG_WINDOW).sum()) > 0
    k = _run(flight.flight_step, args, tables, seeds, 64, **kw)
    p = _run(flight.flight_step_reference, args, tables, seeds, 64, **kw)
    same = torch.ones(N, dtype=torch.bool, device=card)
    for name in INTS:
        same &= getattr(k, name).long() == getattr(p, name).long()
    assert float(same.float().mean()) >= 0.99
    torch.testing.assert_close(k.tally[0], p.tally[0], rtol=1e-3,
                               atol=1e-3 * float(p.tally[0].abs().max()))
    k2 = _run(flight.flight_step, args, tables, seeds, 64, **kw)
    for a, b in zip(k, k2):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def _plan(tables, nz, nr, inline=True, pairs=False):
    return flight.plan_block(nz, nr, tables.sig.shape[1],
                             tables.kgg.shape[1], tables.cdf.shape[1],
                             inline, pairs)


@pytest.mark.parametrize("placement,nz,nr", [("shared", NZ, NR),
                                             ("global", 32, 32)])
def test_table_placement_lane_for_lane(card, placement, nz, nr):
    """Both table placements: 4x3 zones stage their tables in shared
    memory, 32x32 zones (1024, resident) read them from global memory.
    One iteration integers exact and floats rtol 1e-5; 64 iterations >= 99%
    identical lanes; two launches bitwise equal; the global-table launch
    count rises only for the global placement."""
    args, tables, seeds = _inputs(card, seed=5, nz=nz, nr=nr)
    flight.build()
    assert flight.table_placement(nz, nr, N_VOL, N_GG, NUM_NT, True,
                                  False)[0] == placement
    assert _plan(tables, nz, nr).shared == (placement == "shared")
    before = flight.GLOBAL_LAUNCHES
    k = _run(flight.flight_step, args, tables, seeds, 1, nz=nz, nr=nr)
    assert flight.GLOBAL_LAUNCHES == before + (placement == "global")
    p = _run(flight.flight_step_reference, args, tables, seeds, 1, nz=nz,
             nr=nr)
    for name in INTS:
        assert torch.equal(getattr(k, name).long(),
                           getattr(p, name).long()), name
    for name in FLOATS:
        torch.testing.assert_close(getattr(k, name), getattr(p, name),
                                   rtol=1e-5, atol=1e-6)
    k = _run(flight.flight_step, args, tables, seeds, 64, nz=nz, nr=nr)
    p = _run(flight.flight_step_reference, args, tables, seeds, 64, nz=nz,
             nr=nr)
    same = torch.ones(N, dtype=torch.bool, device=card)
    for name in INTS:
        same &= getattr(k, name).long() == getattr(p, name).long()
    assert float(same.float().mean()) >= 0.99
    k2 = _run(flight.flight_step, args, tables, seeds, 64, nz=nz, nr=nr)
    for a, b in zip(k, k2):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_slots_span_several_block_ranges(card):
    """16 tiles whose live photons fill each tile only in part, the last
    tile only in its first quarter: several blocks, each ending inside a
    tile (blocks smaller than a tile). One iteration integers exact and
    floats rtol 1e-5, 32 iterations >= 99% identical lanes, the tallies
    within 1e-3 of their largest zone."""
    n = 16 * flight.TILE
    rng = np.random.default_rng(6)
    args, tables, seeds = _inputs(card, seed=6)
    big = [torch.cat([a] * 4) for a in args]   # the 4-tile inputs, 4 times
    alive = torch.as_tensor(rng.uniform(size=n) < 0.6, device=card)
    alive[-flight.TILE + flight.TILE // 4:] = False
    big[FIELDS.index("alive")] = alive
    seeds = torch.as_tensor(rng.integers(-2**31, 2**31, n // flight.TILE),
                            dtype=torch.int32, device=card)
    flight.build()
    plan = _plan(tables, NZ, NR)
    assert n // plan.threads > 1 and plan.threads % flight.TILE != 0
    k = _run(flight.flight_step, big, tables, seeds, 1)
    p = _run(flight.flight_step_reference, big, tables, seeds, 1)
    for name in INTS:
        assert torch.equal(getattr(k, name).long(),
                           getattr(p, name).long()), name
    for name in FLOATS:
        torch.testing.assert_close(getattr(k, name), getattr(p, name),
                                   rtol=1e-5, atol=1e-6)
    k = _run(flight.flight_step, big, tables, seeds, 32)
    p = _run(flight.flight_step_reference, big, tables, seeds, 32)
    same = torch.ones(n, dtype=torch.bool, device=card)
    for name in INTS:
        same &= getattr(k, name).long() == getattr(p, name).long()
    assert float(same.float().mean()) >= 0.99
    assert not bool(k.alive[-flight.TILE + flight.TILE // 4:].any())
    torch.testing.assert_close(k.tally[0], p.tally[0], rtol=1e-3,
                               atol=1e-3 * float(p.tally[0].abs().max()))


def test_simt_counters_add_up_to_the_plain_lane_iterations(card):
    """The kernel's lane-iteration counter over its blocks equals the
    plain version's lane-iterations, the sum over iterations m < 12 of the
    lanes live after m iterations; each warp pass runs at most 32 of them,
    there is one row of counters per warp, and it_used is the plain
    version's."""
    args, tables, seeds = _inputs(card, seed=7)
    iters = 12
    k = _run(flight.flight_step, args, tables, seeds, iters)
    plain = 0
    for m in range(iters):
        p = _run(flight.flight_step_reference, args, tables, seeds, m)
        live = (p.alive & (p.flag == flight.FLAG_NONE)
                & ((p.mode != flight.MODE_FLY) | (p.dcen > 0.0)))
        plain += int(live.sum())
    c = k.counters.sum(dim=0, dtype=torch.int64).tolist()
    assert c[0] == plain > 0
    assert c[0] <= 32 * (c[1] + c[2] + c[3])
    assert tuple(k.counters.shape) == (N // 32, flight.N_COUNT)
    p = _run(flight.flight_step_reference, args, tables, seeds, iters)
    assert k.it_used == p.it_used


DECK_WIDTHS = {
    "disk_deck": dict(num_nt=50, n_vol=64, nphfield=64, n_gg=32, n_ref=100),
    "ec_deck": dict(num_nt=100, n_vol=128, nphfield=128, n_gg=32,
                    n_ref=100),
}


def _deck_step(name, dirpath, device, seed=3):
    """One step of the deck ``name`` (3x2 zones, nst 3000, 4096 slots)
    on ``device``: the audit, its reflection share sum(ed_ref) E / avail,
    and the step's outputs."""
    import os

    from compton2d_tpu_torch import decks
    from compton2d_tpu_torch.driver import Simulation

    os.makedirs(dirpath, exist_ok=True)
    lc = decks.load_deck(name, dirpath, grid=DECK_WIDTHS[name], nz=3, nr=2,
                         nst=3000, seed=seed, n_slots=4096,
                         event_capacity=4096)
    sim = Simulation(lc.cfg, lc.zones, device=device)
    out = sim.step()
    a = sim.energy_audit()
    avail = a["input"] - a["src_lost"] + a["scatter_gain"] - a["rr"]
    extra = float(out.tallies.ed_ref.sum()) * sim.scales.E / avail
    return a, extra, out


@pytest.mark.parametrize("name", ["disk_deck", "ec_deck"])
def test_deck_step_on_the_card_against_the_plain_path(card, name,
                                                      tmp_path):
    """One step of each deck on the card and on the CPU plain path: both
    audits within 2e-3 once the reflection share is added to 1 (a
    reflected photon is tallied twice, as in the reference), the card's
    step through the flight kernel, and its escaped energy and reflection
    share within 60% of the plain path's (the two draw different random
    streams; nst 3000 spreads these totals by ~30% between seeds)."""
    launches = flight.LAUNCHES
    a_k, x_k, out_k = _deck_step(name, str(tmp_path / "card"), card)
    assert flight.LAUNCHES > launches
    a_p, x_p, _ = _deck_step(name, str(tmp_path / "plain"), "cpu")
    for a, x in ((a_k, x_k), (a_p, x_p)):
        assert abs(a["balance"] - (1.0 + x)) < 2e-3, (a, x)
    rel = abs(a_k["escaped"] - a_p["escaped"]) / a_p["escaped"]
    assert rel < 0.6, (a_k["escaped"], a_p["escaped"])
    if name == "disk_deck":
        assert x_k > 0.0 and abs(x_k - x_p) / x_p < 0.6, (x_k, x_p)
        assert int(out_k.tallies.n_reflect_lower) > 0
    else:
        assert x_k == x_p == 0.0


def _tiny_cell(name, root, **grid):
    """The configuration and zones of benchmark cell ``name`` at the tiny
    sizes of ``benchmark/tests/conftest.py`` (files written under
    ``root``), with the grid's keys ``grid`` changed."""
    import importlib.util
    import shutil
    import sys
    from pathlib import Path

    bench = Path(__file__).resolve().parent.parent / "benchmark"
    shutil.copytree(bench, root / "benchmark", ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    shutil.copy(bench.parent / "BENCHMARK.json", root)
    spec = importlib.util.spec_from_file_location(
        "bench_tests_conftest", bench / "tests" / "conftest.py")
    conf = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(conf)
    conf.tiny_files(root / "benchmark")
    if str(bench) not in sys.path:
        sys.path.insert(0, str(bench))
    from harness import specs

    w = specs.load_workload(name, root / "benchmark")
    c = specs.load_config(w["config"], root / "benchmark")
    c["grid"].update(grid)
    return specs.sim_config(c, w, 2 ** 31 + 3)


@pytest.mark.parametrize("cell, grid", [
    ("tiny_blob.run", {}), ("tiny_corona.evolve", {}),
    ("tiny_corona.evolve", dict(nz=40, nr=30))])
def test_every_sync_of_a_step_is_a_counted_read(card, cell, grid,
                                                tmp_path):
    """Under ``torch.cuda.set_sync_debug_mode("warn")`` every synchronising
    call of a step (after one warm step; the blob with its event file and
    outputs; the corona also on a 40x30 grid, in the kernel's windowed
    mode) happens inside ``telemetry.read``, and the reads in which the
    card synchronised are all the reads the telemetry counts (one read
    may synchronise more than once: ``torch.bincount`` reads back its
    smallest and its largest index)."""
    import traceback
    import warnings

    from compton2d_tpu_torch import telemetry as tm
    from compton2d_tpu_torch.driver import Simulation

    cfg, zones = _tiny_cell(cell, tmp_path, **grid)
    sim = Simulation(cfg, zones, device=card)
    if cell == "tiny_blob.run":
        sim.attach_outputs(str(tmp_path / "out"))
    sim.step()
    torch.cuda.synchronize()
    synced, loose = set(), []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        if any(f.name == "read" and f.filename.endswith("telemetry.py")
               for f in stack):
            # the reads counted so far number the read in progress
            synced.add(sum(c for c, _ in tm._reads.values()))
        else:
            loose.append(" < ".join(f"{f.filename.rsplit('/', 1)[-1]}:"
                                    f"{f.lineno}" for f in stack[-4:][::-1]))

    tm.reset()
    tm.enable()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            torch.cuda.set_sync_debug_mode("warn")
            # a warning the card had kept from before the step is not its
            synced.clear()
            loose.clear()
            try:
                sim.step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        tm.disable()
    reads = tm.snapshot()["reads"]
    tm.reset()
    assert not loose, loose[:20]
    n = sum(r["count"] for r in reads.values())
    assert synced == set(range(n)) and n > 0, (sorted(synced), reads)
