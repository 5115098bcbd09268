"""The zone pass's synchrotron sums: on the CPU, the properties the
hand-written kernel ``csrc/volume_em.cu`` rests on (a zone's sums depend
on no other zone; the terms it skips are exactly 0 and lead each photon
bin's run over gamma; CPU tensors take the plain version); on a CUDA
card, the kernel against its plain PyTorch version
(``physics.emissivity.sync_sums_reference``, ``compare_volume_em``) on
the benchmark cells' own zone states, on zones without electrons, below
the plasma frequency or not finite, term by term, and its one launch a
step on the main path.

The card tests need the card and skip without one. This file imports
neither jax nor the JAX package, so it also runs on a machine without
jax:

    python3 -m pytest --noconftest tests/test_torch_volume_em_kernel.py -q
"""
import numpy as np
import pytest
import torch

from compton2d_tpu_torch import compare_volume_em as cve
from compton2d_tpu_torch import constants as cn
from compton2d_tpu_torch import roofline
from compton2d_tpu_torch import telemetry as tm
from compton2d_tpu_torch.examples import small_corona
from compton2d_tpu_torch.physics import emissivity as em
from compton2d_tpu_torch.physics.electron_dist import gnt_grid
from compton2d_tpu_torch.tables import e_field_grid

torch.set_num_threads(2)

GRID = dict(nz=4, nr=3, nst=500, n_slots=1024, num_nt=60, n_vol=96,
            nphfield=32)


def _zone_args(device, seed=0):
    """volume_em's arguments on a 4x3 corona whose zones differ: B 0.03 to
    300 G, tea 5 to 500 keV, n_e 1e8 to 1e16 (the densest zones' plasma
    frequency above the lowest photon bins), random tails, and one zone
    without electrons."""
    sim = small_corona(**GRID, device=device)
    z, g = sim.state.zones, sim.grid
    gen = torch.Generator().manual_seed(seed)
    shape = z.tea.shape

    def logu(lo, hi, *s):
        u = torch.rand(*(s or shape), generator=gen, dtype=torch.float64)
        return (10.0 ** (np.log10(lo) + u * np.log10(hi / lo))).to(
            torch.float32).to(device)

    f_nt = logu(1e-8, 1.0, *z.f_nt.shape)
    f_nt[0, 0] = 0.0
    l_min = torch.minimum(g.dz, g.dr) * torch.ones_like(g.vol)
    return ((sim.tables.e_ph, sim.tables.gnt, f_nt, logu(5.0, 500.0),
             logu(1e8, 1e16), logu(0.03, 300.0), z.amxwl, g.vol,
             g.zone_surf, l_min, sim.state.dt, sim.scales),
            dict(f_pair=logu(1e-6, 1e-2)))


def _zones(args, kw, idx):
    """volume_em's arguments of the zones ``idx`` alone, as the zone farm
    passes a slice: a (len(idx), 1) grid."""
    def part(x):
        return x.reshape((-1,) + tuple(x.shape[2:]))[idx].reshape(
            (len(idx), 1) + tuple(x.shape[2:]))

    a = args[:2] + tuple(part(x) for x in args[2:10]) + args[10:]
    return a, {k: part(v) for k, v in kw.items()}


@pytest.mark.parametrize("groups", ["one_by_one", "ranks_of_4", "ranks_of_3",
                                    "chunks_of_5"])
def test_plain_sums_of_zone_groups_equal_the_whole_grid(groups, monkeypatch):
    """volume_em on groups of zones, each passed alone, equals the whole
    grid's rows bit for bit in every output: a zone's sums over gamma, and
    all that follows them, depend on nothing outside the zone. So the
    kernel's one fixed order per zone, and the plain version's, give the
    zone farm's slices what the whole grid gives (corona99.ranks4's
    ``ranks_diff`` 0)."""
    args, kw = _zone_args("cpu")
    Z = GRID["nz"] * GRID["nr"]
    if groups == "chunks_of_5":
        # the whole grid in chunks of 5 zones, the groups single zones
        monkeypatch.setattr(em, "ZONE_CHUNK_ELEMS",
                            5 * GRID["n_vol"] * GRID["num_nt"])
        parts = [[z] for z in range(Z)]
    elif groups == "one_by_one":
        parts = [[z] for z in range(Z)]
    else:
        world = int(groups[-1])
        parts = [cve.rank_zones(Z, r, world) for r in range(world)]
    whole = em.volume_em(*args, **kw)
    assert torch.count_nonzero(whole.kappa_tot) > 0
    for idx in parts:
        a, k = _zones(args, kw, idx)
        part = em.volume_em(*a, **k)
        for name, w in whole._asdict().items():
            w = w.reshape((Z,) + tuple(w.shape[2:]))[idx]
            p = getattr(part, name).reshape(w.shape)
            assert torch.equal(w, p), (name, idx)


@pytest.mark.parametrize("b_gauss, share", [(10.0, 0.4270), (0.1, 0.5270)])
def test_skipped_terms_are_exact_zeros_leading_each_run(b_gauss, share):
    """A term with t >= 1e4, or t NaN, is exactly +0.0 in the plain
    version, and so is (face F) fw for a finite face and fw: adding it
    changes no sum. So is a term whose factor exp(-2 min(ts, 60))
    underflows (the kernel's second skip). t falls as gamma rises on the
    port's grids (200 electron, 400 photon bins), so those terms lead each
    photon bin's run over gamma; at corona99's 10 G the terms with
    t >= 1e4 are 42.7% of all, at the Mrk 421 blob's 0.1 G 52.7%."""
    big = torch.tensor([1.0e4, 1.5e4, 2.0e4, 1.0e6, 3.0e38, float("inf"),
                        float("nan")])
    shape = em.sync_kernel_f32(big)
    assert torch.equal(shape, torch.zeros_like(big))
    assert not torch.any(torch.signbit(shape))
    face = torch.tensor([[4.7e-21], [1.0], [-3.0e30]])
    fw = torch.tensor([1e-30, -2.0, 1e30, 0.0])
    terms = (face[:, :, None] * shape[None, None, :, None]) * fw
    assert torch.count_nonzero(terms) == 0
    # below 1e4, where the shape's factor exp(-2 min(ts, 60)) underflows,
    # the fits are finite and the shape is exactly 0 too
    t = torch.logspace(1.0, 4.0, 4001)[:-1]
    under = torch.exp(-2.0 * torch.clamp_max(t, 60.0)) == 0.0
    assert 0 < int(under.sum()) < len(t)
    assert torch.count_nonzero(em.sync_kernel_f32(t[under])) == 0
    assert torch.all(em.sync_kernel_f32(t[~under][:10]) > 0.0)

    gamma = torch.as_tensor(gnt_grid(200) + 1.0, dtype=torch.float32)
    e_ph = torch.as_tensor(e_field_grid(400), dtype=torch.float32)
    nu21 = (2.41487e17 / 1e21 * e_ph).to(torch.float32)
    B = torch.full((3, 1), b_gauss)
    nu_b = em._E_CHARGE * B / (2.0 * np.pi * em._E_MASS * cn.C_LIGHT)
    x = cve.SumsInputs(nu21, gamma, nu_b, torch.ones(3, 1),
                       torch.ones(3, 200), torch.ones(3, 200))
    (_, t), = list(cve._terms(x))
    skip = ~(t < 1.0e4)
    assert torch.all(skip[..., 1:] <= skip[..., :-1])     # a leading run
    assert torch.all(t[..., 1:] <= t[..., :-1])
    assert abs(cve.skipped_shares(x)[0] - share) < 5e-4


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """On CPU tensors volume_em sums with the plain version and launches
    nothing; ``sync_sums`` is ``sync_sums_reference`` there, bit for
    bit."""
    def no_kernel(*a):
        raise AssertionError("the kernel path on CPU tensors")

    monkeypatch.setattr(em, "sync_sums_kernel", no_kernel)
    args, kw = _zone_args("cpu", seed=1)
    em.reset_launch_counts()
    got = []
    plain = em.sync_sums_reference

    def counted(*a):
        got.append(a)
        return plain(*a)

    monkeypatch.setattr(em, "sync_sums_reference", counted)
    ve = em.volume_em(*args, **kw)
    assert len(got) == 1 and em.launch_counts() == {"volume_em": 0}
    assert torch.all(torch.isfinite(ve.kappa_tot))
    j, k = em.sync_sums(*got[0])
    jp, kp = plain(*got[0])
    assert torch.equal(j, jp) and torch.equal(k, kp)


def test_other_devices_are_refused():
    """Tensors neither on the CPU nor on a CUDA card are refused, not
    summed by the plain version."""
    x = cve.SumsInputs(*(torch.ones(*s, device="meta") for s in
                         ((8,), (5,), (3, 1), (3, 1), (3, 5), (3, 5))))
    with pytest.raises(ValueError, match="unsupported device"):
        em.sync_sums(*x)


@pytest.mark.parametrize("grid, world", [((99, 99, 400, 200), 1),
                                         ((99, 99, 400, 200), 4),
                                         ((10, 4, 400, 200), 1)])
def test_kernel_bound_is_the_benchmark_model(grid, world):
    """``roofline.volume_em_bound``, the kernel's bound in ``chip_smoke.py``
    phase 14, is the least time of ``volume_em_roofline_pct``'s model
    (on ranks of a rank's slice of the zones): the share it reads when the
    zone pass takes just that long is 100%."""
    import sys
    from types import SimpleNamespace

    if str(cve.BENCH) not in sys.path:
        sys.path.insert(0, str(cve.BENCH))
    from harness import specs

    nz, nr, n_vol, num_nt = grid
    zones = -(-nz * nr // world)
    bound = roofline.volume_em_bound(zones, n_vol, num_nt)
    assert bound["bound_by"] == "operations"
    m = SimpleNamespace(
        cfg=SimpleNamespace(grid=SimpleNamespace(nz=nz, nr=nr, n_vol=n_vol,
                                                 num_nt=num_nt),
                            run=SimpleNamespace(zone_shard=True)),
        world=world, steps=3, spans_ms={"zone_pass": 3 * bound["bound_ms"]})
    share = specs.load_metric("volume_em_roofline_pct").read(m)
    assert share == pytest.approx(100.0, rel=1e-12)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    em.build()
    return torch.device("cuda")


def _check(x, label):
    c = cve.compare(x)
    print(cve.describe(c, label))
    assert cve.departures(c) == []
    return c


# benchmark cell -> main-path steps after its set-up, compared at the last
CELL_STEPS = {"corona99.evolve": 1, "mrk421_dense.to_tstop": 5,
              "pair_corona.evolve": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["corona99.evolve", "corona99.ranks4",
                                  "mrk421_dense.to_tstop",
                                  "pair_corona.evolve"])
def test_kernel_against_plain_version_on_cell_states(card, cell):
    """Each benchmark cell's configuration after its set-up steps: one
    launch a step, and the kernel's sums within what the order of the sums
    allows of the plain version's. corona99.ranks4: each rank's 2451-zone
    slice of the 99x99 grid (``zone_slice``, the last zone repeated into
    the pad) against the plain version, and its rows bit for bit the whole
    grid's."""
    name = "corona99.evolve" if cell == "corona99.ranks4" else cell
    sim, setup = cve.cell_sim(name, card)
    sim.run(setup)
    em.reset_launch_counts()
    recorded = cve.sums_inputs(sim, CELL_STEPS[name])
    assert em.launch_counts()["volume_em"] == len(recorded) \
        == CELL_STEPS[name]
    del sim
    x = recorded[-1]
    if cell != "corona99.ranks4":
        _check(x, cell)
        return
    j, k = em.sync_sums(*x)
    Z = x.fw.shape[0]
    for rank in range(cve.RANKS):
        idx = cve.rank_zones(Z, rank)
        part = cve.zone_part(x, idx)
        c = _check(part, f"{cell} rank {rank}")
        assert c.j.shape[0] == 2451
        assert torch.equal(c.j, j[idx]) and torch.equal(c.k, k[idx])


@pytest.mark.cuda
def test_zones_without_electrons_below_the_plasma_frequency_or_odd(
        card, monkeypatch):
    """Zones without electrons sum to exactly 0; zones whose plasma
    frequency lies above photon bins give volume_em's 0 there; a zone with
    a NaN or an inf in its rows sums as the plain version does (its
    skipped terms are then (face 0) fw, not 0)."""
    args, kw = _zone_args(card, seed=2)
    f_nt = args[2].clone()
    f_nt[1, 0, 7] = float("nan")
    f_nt[1, 1, 30] = float("inf")
    args = args[:2] + (f_nt,) + args[3:]
    got = []
    sums = em.sync_sums
    monkeypatch.setattr(em, "sync_sums", lambda *a: got.append(
        cve.SumsInputs(*a)) or sums(*a))
    ve = em.volume_em(*args, **kw)
    monkeypatch.undo()
    x, = got
    c = _check(x, "odd zones")
    assert torch.count_nonzero(c.j[0]) == torch.count_nonzero(c.k[0]) == 0
    assert torch.all(torch.isnan(c.j[3])) and not torch.any(
        torch.isfinite(c.j[4]))
    nu_p21 = 9.0e3 / 1e21 * torch.sqrt(args[4].reshape(-1, 1))
    below = x.nu21 <= nu_p21
    assert torch.any(below)
    assert torch.count_nonzero(ve.kappa_tot.reshape(below.shape)[below]) == 0


@pytest.mark.cuda
def test_each_term_alone_equals_the_plain_version(card):
    """One electron bin a zone (fw and sg one-hot rows, every bin in
    turn, B from 0.01 to 1000 G): each sum is then one term, whatever the
    order, so the kernel's equals the plain version's bit for bit when
    each term's operations are the plain version's."""
    N, V, Z = 200, 400, 400
    gamma = torch.as_tensor(gnt_grid(N) + 1.0, dtype=torch.float32,
                            device=card)
    e_ph = torch.as_tensor(e_field_grid(V), dtype=torch.float32, device=card)
    nu21 = (2.41487e17 / 1e21 * e_ph).to(torch.float32)
    B = torch.logspace(-2, 3, Z, device=card).reshape(Z, 1)
    nu_b = em._E_CHARGE * B / (2.0 * np.pi * em._E_MASS * cn.C_LIGHT)
    face = 3.0**1.5 * em._SIGMA_T * cn.C_LIGHT * (B * B / (8.0 * np.pi)) / (
        np.pi * nu_b)
    z = torch.arange(Z, device=card)
    fw = torch.zeros(Z, N, device=card)
    sg = torch.zeros(Z, N, device=card)
    fw[z, z % N] = 1.0
    sg[z, (7 * z + 3) % N] = -2.5
    x = cve.SumsInputs(nu21, gamma, nu_b, face, fw, sg)
    j, k = em.sync_sums(*x)
    jp, kp = em.sync_sums_reference(*x)
    print(f"one term a sum: {torch.count_nonzero(jp)} of {jp.numel()} "
          f"nonzero; equal {int(torch.sum(j == jp))}, "
          f"{int(torch.sum(k == kp))} of {j.numel()}")
    assert torch.count_nonzero(jp) > j.numel() // 4
    assert torch.equal(j, jp) and torch.equal(k, kp)


@pytest.mark.cuda
def test_one_launch_a_step_on_the_main_path(card, monkeypatch):
    """The main path's zone pass launches the kernel once a step, never
    the plain version, and the telemetry snapshot's ``launches`` counts
    it."""
    def no_plain(*a):
        raise AssertionError("the plain version on CUDA tensors")

    sim = small_corona(nz=8, nr=4, nst=3000, n_slots=8192, num_nt=200,
                       n_vol=400, nphfield=64, device=card)
    monkeypatch.setattr(em, "sync_sums_reference", no_plain)
    em.reset_launch_counts()
    tm.reset()
    tm.enable()
    try:
        for _ in range(3):
            sim.step()
        snap = tm.snapshot()
    finally:
        tm.disable()
        tm.reset()
    assert em.launch_counts() == {"volume_em": 3}
    assert snap["launches"]["volume_em"] == 3
