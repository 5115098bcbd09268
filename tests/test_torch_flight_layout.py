"""The flight kernel's table layout and the premise of its scheduling, on
the CPU: the packed tables hold the natural ones bit for bit, the table
placement is the pure function of the shapes that the kernel's grid plan
reads, and each photon's result in the plain version does not depend on
which other photons fly beside it (the premise of running photons in any
grouping; the kernel's per-lane outputs equal the plain version's lane
for lane).

No JAX is needed: the existing flight tests hold the plain version
against ``flight_step_v2(..., interpret=True)``."""
import numpy as np
import pytest
import torch

from compton2d_tpu_torch.physics.electron_dist import gnt_grid
from compton2d_tpu_torch.state import PhotonArray
from compton2d_tpu_torch.tables import e_field_grid, e_gg_grid
from compton2d_tpu_torch.transport import flight, population

torch.set_num_threads(2)

FIELDS = PhotonArray._fields
LANE_OUTPUTS = ("e", "w", "r", "z", "mu", "cphi", "sphi", "dcen", "jz", "kr",
                "alive", "mode", "flag", "jn", "kn", "sct_cnt", "iglog",
                "delog")
C_LIGHT = float(np.float32(2.9979245620e10))


def _tables(nz, nr, n_vol, num_nt, n_gg, seed=0, kappa=(0.0, 0.1)):
    """Random zone tables on the port's grids, with a kgg table."""
    rng = np.random.default_rng(seed)
    nzr = nz * nr
    e_ph = e_field_grid(n_vol).astype(np.float32)
    gnt = gnt_grid(num_nt).astype(np.float32)
    opac = np.stack([
        rng.uniform(2.0, 8.0, (nzr, 1)) / (1.0 + e_ph[None, :] / 511.0),
        rng.uniform(*kappa, (nzr, 1)) * np.ones((1, n_vol)),
    ], axis=-1)
    pdf = np.exp(-gnt[None, :] / rng.uniform(0.05, 0.4, (nzr, 1)))
    cdf = np.cumsum(pdf, axis=1) / pdf.sum(axis=1, keepdims=True)
    e_gg = e_gg_grid(n_gg).astype(np.float32)
    kgg = rng.uniform(0.5, 3.0, (nzr, 1)) * np.linspace(0.1, 1.0, n_gg)
    t = torch.as_tensor
    return flight.build_flight_tables(
        t(opac, dtype=torch.float32), t(cdf, dtype=torch.float32), t(gnt),
        t(np.linspace(0, 1, nr + 1), dtype=torch.float32),
        t(np.linspace(0, 1, nz + 1), dtype=torch.float32),
        float(np.log(e_ph[0])), float(np.log(e_ph[1] / e_ph[0])),
        u_edges=torch.as_tensor(flight.guide_u_edges()),
        kgg_zone=t(kgg, dtype=torch.float32),
        e_gg_log0=float(np.log(e_gg[0])),
        e_gg_dlog=float(np.log(e_gg[1] / e_gg[0])))


def _section(tables, name, dtype, shape):
    nz, nr = tables.z_edges.shape[0] - 1, tables.r_edges.shape[0] - 1
    lay = flight.packed_layout(nz, nr, tables.sig.shape[1],
                               tables.kgg.shape[1], tables.cdf.shape[1])
    off, nbytes = lay[name]
    assert off % 16 == 0
    return tables.packed[off:off + nbytes].view(dtype).reshape(shape)


def test_packed_tables_hold_the_natural_tables_bit_for_bit():
    """sigma/kappa interleaved, kgg, the r then z edges, the CDF, the
    uint16 guide and gamma-1 in the packed bytes equal the natural tables
    (the guide as int32), each section on 16 bytes."""
    nz, nr, n_vol, num_nt, n_gg = 3, 2, 17, 23, 5
    tab = _tables(nz, nr, n_vol, num_nt, n_gg)
    nzr = nz * nr
    opac = _section(tab, "opac", torch.float32, (nzr, n_vol, 2))
    assert torch.equal(opac[:, :, 0], tab.sig)
    assert torch.equal(opac[:, :, 1], tab.kap)
    assert torch.equal(_section(tab, "kgg", torch.float32, (nzr, n_gg)),
                       tab.kgg)
    edges = _section(tab, "edges", torch.float32, (nz + nr + 2,))
    assert torch.equal(edges, torch.cat([tab.r_edges, tab.z_edges]))
    assert torch.equal(_section(tab, "cdf", torch.float32, (nzr, num_nt)),
                       tab.cdf)
    guide = _section(tab, "guide", torch.uint16, (nzr, flight.GUIDE_G))
    assert torch.equal(guide.to(torch.int32), tab.guide)
    assert int(tab.guide.max()) > 0
    assert torch.equal(_section(tab, "gm1", torch.float32, (num_nt - 1,)),
                       tab.gm1)
    lay = flight.packed_layout(nz, nr, n_vol, n_gg, num_nt)
    off, nbytes = lay[flight.SECTIONS[-1]]
    assert tab.packed.dtype == torch.uint8
    assert tab.packed.numel() == -(-(off + nbytes) // 16) * 16


def _linear_cdf_tables(num_nt):
    """One zone whose CDF rises linearly over num_nt bins."""
    t = torch.as_tensor
    f32 = torch.float32
    return flight.build_flight_tables(
        t(np.ones((1, 4, 2)), dtype=f32),
        t(np.linspace(0.0, 1.0, num_nt)[None, :], dtype=f32),
        t(np.geomspace(1e-4, 1e4, num_nt), dtype=f32),
        t([0.0, 1.0], dtype=f32), t([0.0, 1.0], dtype=f32), 0.0, 1.0,
        u_edges=torch.as_tensor(flight.guide_u_edges()))


def test_uint16_guide_limits_num_nt():
    """The packed guide holds counts below num_nt in uint16: num_nt of
    65535 or more raises, 65534 builds with its counts intact."""
    with pytest.raises(ValueError, match="65535"):
        _linear_cdf_tables(65535)
    tab = _linear_cdf_tables(65534)
    guide = _section(tab, "guide", torch.uint16, (1, flight.GUIDE_G))
    assert torch.equal(guide.to(torch.int32), tab.guide)
    assert int(tab.guide.max()) > 65000


# (nz, nr, n_vol, n_gg, num_nt, inline_scatter, pair_switch): the bytes a
# mode reads and where they live
PLACEMENTS = [
    pytest.param((8, 4, 400, 2, 200, True, False), ("shared", 161620),
                 id="main path B1"),
    pytest.param((10, 4, 400, 2, 200, False, False), ("shared", 128064),
                 id="Mrk 421 B3"),
    pytest.param((4, 3, 128, 32, 100, True, True), ("shared", 31344),
                 id="pair corona B2"),
    pytest.param((4, 3, 128, 32, 100, False, True), ("shared", 13860),
                 id="B2 with B3"),
    pytest.param((99, 99, 400, 2, 200, True, False), ("global", 49241820),
                 id="large_corona B4"),
    pytest.param((32, 32, 400, 2, 200, True, False), ("global", 5145636),
                 id="32x32 resident"),
    pytest.param((10, 4, 400, 2, 200, True, False), ("shared", 201820),
                 id="Mrk 421 grid inline"),
    pytest.param((16, 16, 400, 2, 200, True, False), ("global", 1287076),
                 id="16x16 inline"),
]


@pytest.mark.parametrize("shape,want", PLACEMENTS)
def test_table_placement_of_the_path_shapes(shape, want):
    """The paths' staged bytes (sigma/kappa and the edges always, kgg
    under pair_switch, the scatter tables with the scatter inlined) and
    their placement: shared memory where they fit beside the rest of the
    largest block's layout, global memory otherwise and in the windowed
    mode."""
    assert flight.table_placement(*shape) == want
    nz, nr, n_vol, n_gg, num_nt, inline, pairs = shape
    lay = flight.packed_layout(nz, nr, n_vol, n_gg, num_nt)
    staged = {k: lay[k][1] for k in flight.staged_sections(inline, pairs)}
    assert sum(staged.values()) == want[1]
    offs, total = flight._smem_layout(staged, nz * nr,
                                      max(flight.BLOCK_THREADS))
    assert all(v % 16 == 0 for v in offs.values())
    assert (want[0] == "shared") == (flight.window_z(nz, nr) == 0
                                     and total <= flight.SMEM_MAX)


def _photons(n, nz, nr, seed, pairs=False):
    rng = np.random.default_rng(seed)
    jz, kr = rng.integers(0, nz, n), rng.integers(0, nr, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    log_e = rng.uniform(1, 4, n) if pairs else rng.uniform(-2, 2, n)
    f32 = torch.float32
    t = torch.as_tensor
    ph = dict(
        e=t(10.0 ** log_e, dtype=f32),
        w=t(rng.uniform(0.5, 1.5, n), dtype=f32),
        r=t((kr + rng.uniform(0.01, 0.99, n)) / nr, dtype=f32),
        z=t((jz + rng.uniform(0.01, 0.99, n)) / nz, dtype=f32),
        mu=t(rng.uniform(-1, 1, n), dtype=f32), cphi=t(np.cos(phi), dtype=f32),
        sphi=t(np.sin(phi), dtype=f32),
        dcen=t(rng.uniform(0.05, 0.5, n), dtype=f32),
        jz=t(jz, dtype=torch.int32), kr=t(kr, dtype=torch.int32),
        alive=t(rng.uniform(size=n) < 0.9))
    ph["w0"] = ph["w"].clone()
    seeds = t(rng.integers(-2**31, 2**31, n // flight.TILE), dtype=torch.int32)
    return ph, seeds


def _run(ph, alive, tables, seeds, nz, nr, inline, pairs, max_iters=64):
    args = [ph[k] for k in FIELDS[:-1]] + [alive]
    return flight.flight_step_reference(
        *args, tables, seeds, nz=nz, nr=nr, weight_floor=1e-10,
        max_iters=max_iters, max_tries=64, inline_scatter=inline,
        pair_switch=pairs)


# (nz, nr, inline_scatter, pair_switch)
MODES = [
    pytest.param((4, 3, True, False), id="B1"),
    pytest.param((4, 3, False, False), id="B3"),
    pytest.param((4, 3, True, True), id="B2"),
    pytest.param((40, 30, True, False), id="B4 windowed 40x30"),
]


@pytest.mark.parametrize("mode", MODES)
def test_lanes_are_independent(mode):
    """4096 slots, the live lanes split into two disjoint halves (whole
    tiles in the windowed mode, whose window base reads the tile's live
    lanes): each live lane's outputs in its half's run equal the run of
    all of them bitwise, and the halves' tallies and energy sums add up
    to the whole run's within 1e-6 of its scale."""
    nz, nr, inline, pairs = mode
    n = 4 * flight.TILE
    win_z = flight.window_z(nz, nr)
    tables = _tables(nz, nr, 64, 50, 32, seed=1,
                     kappa=(0.25, 0.75) if win_z else (0.0, 0.1))
    ph, seeds = _photons(n, nz, nr, seed=2, pairs=pairs)
    if win_z:
        ph = population.zone_sort(PhotonArray(**ph), nz, nr,
                                  win_z)._asdict()
        half = (torch.arange(n) // flight.TILE) % 2 == 0
    else:
        half = torch.as_tensor(np.random.default_rng(3).uniform(size=n) < 0.5)
    live = ph["alive"] & (ph["dcen"] > 0.0)
    runs = [_run(ph, ph["alive"] & m, tables, seeds, nz, nr, inline, pairs)
            for m in (half, ~half)]
    full = _run(ph, ph["alive"], tables, seeds, nz, nr, inline, pairs)
    assert int((full.sct_cnt > 0).sum()) > 0 or not inline
    if win_z:
        assert int((full.flag == flight.FLAG_WINDOW).sum()) > 0
    for m, res in zip((half, ~half), runs):
        sel = live & m
        assert int(sel.sum()) > 100
        for f in LANE_OUTPUTS:
            a, b = getattr(res, f), getattr(full, f)
            if a.shape[0] == 0:
                continue
            assert torch.equal(a[sel], b[sel]), f
    ed = runs[0].tally[0] + runs[1].tally[0]
    scale = float(torch.max(torch.abs(full.tally[0])))
    torch.testing.assert_close(ed, full.tally[0], rtol=0.0, atol=1e-6 * scale)
    torch.testing.assert_close(runs[0].tally[1] + runs[1].tally[1],
                               full.tally[1], rtol=0.0,
                               atol=1e-6 * C_LIGHT * scale)
    e_in = float(torch.sum(ph["w"]))
    for f in ("ekill", "esct", "epair"):
        torch.testing.assert_close(getattr(runs[0], f) + getattr(runs[1], f),
                                   getattr(full, f), rtol=0.0,
                                   atol=1e-6 * e_in)
