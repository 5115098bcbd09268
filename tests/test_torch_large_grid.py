"""The port's large-grid path (grids above 1024 zones) against the JAX
package: the zone sort, the flight kernel's windowed mode (its plain
version against ``flight_step_v2(..., win_z=128, interpret=True)``), the
per-window tally recombination, tracking's FLAG_WINDOW rounds, the
chunked ``volume_em``, and 40x30 steps of ``small_corona`` against the
reference's Pallas path in interpret mode."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compton2d_tpu import config as jcfg
from compton2d_tpu import examples as jex
from compton2d_tpu import tables as jtables
from compton2d_tpu import units as junits
from compton2d_tpu.physics import electron_dist as jed
from compton2d_tpu.physics import emissivity as jem
from compton2d_tpu.state import PhotonArray as JPhotons
from compton2d_tpu.transport import flight_pallas2 as fp2
from compton2d_tpu.transport import population as jpop
from compton2d_tpu_torch import config as pcfg
from compton2d_tpu_torch import driver
from compton2d_tpu_torch import examples as pex
from compton2d_tpu_torch import tables as ptables
from compton2d_tpu_torch import units as punits
from compton2d_tpu_torch.physics import emissivity as pem
from compton2d_tpu_torch.state import PhotonArray
from compton2d_tpu_torch.transport import flight, population

torch.set_num_threads(2)

NZ, NR = 40, 30                 # tests/test_flight_pallas2.py's grid
FIELDS = PhotonArray._fields
INTS = {"jz": 8, "kr": 9, "alive": 10, "mode": 11, "flag": 12, "jn": 13,
        "kn": 14, "sct_cnt": 19}
FLOATS = {"e": 0, "w": 1, "r": 2, "z": 3, "mu": 4, "cphi": 5, "sphi": 6,
          "dcen": 7}


def _photons(n, seed, nz=NZ, nr=NR, dead=0.1):
    """numpy photon SoA with positions inside each slot's zone (edges
    linspace(0, 1)); ``dead`` of the slots are free."""
    rng = np.random.default_rng(seed)
    jz, kr = rng.integers(0, nz, n), rng.integers(0, nr, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    f = np.float32
    return dict(
        e=rng.uniform(1.0, 10.0, n).astype(f), w=np.ones(n, f),
        w0=np.ones(n, f),
        r=((kr + rng.uniform(0.01, 0.99, n)) / nr).astype(f),
        z=((jz + rng.uniform(0.01, 0.99, n)) / nz).astype(f),
        mu=rng.uniform(-1, 1, n).astype(f), cphi=np.cos(phi).astype(f),
        sphi=np.sin(phi).astype(f), dcen=rng.uniform(0.05, 0.5, n).astype(f),
        jz=jz.astype(np.int32), kr=kr.astype(np.int32),
        alive=rng.uniform(size=n) >= dead,
    )


def _sorted(ph, nz=NZ, nr=NR):
    """The port's zone sort of a numpy SoA, as numpy."""
    out = population.zone_sort(
        PhotonArray(*(torch.as_tensor(ph[k]) for k in FIELDS)), nz, nr,
        flight.WIN_Z)
    return {k: getattr(out, k).numpy() for k in FIELDS}


def test_zone_sort_matches_reference_bit_for_bit():
    """The stable argsort by zone bucket gives the reference's one-hot
    cumsum permutation: every field equal, dead slots last."""
    ph = _photons(8 * fp2.TILE, seed=0, dead=0.3)
    ref = jpop.zone_sort(JPhotons(**{k: jnp.asarray(ph[k]) for k in FIELDS}),
                         NZ, NR, fp2.WIN_Z)
    got = _sorted(ph)
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(ref, k)),
                                      err_msg=k)
    n_alive = int(ph["alive"].sum())
    assert got["alive"][:n_alive].all() and not got["alive"][n_alive:].any()
    zid = got["jz"][:n_alive] * NR + got["kr"][:n_alive]
    assert np.all(np.diff(zid // fp2.WIN_Z) >= 0)


def _tables(seed, nz=NZ, nr=NR, n_vol=48, num_nt=40):
    rng = np.random.default_rng(seed)
    nzr = nz * nr
    e_ph = np.geomspace(1e-3, 1e3, n_vol)
    opac = np.zeros((nzr, n_vol, 2), np.float32)
    opac[:, :, 0] = rng.uniform(1.5, 4.5, (nzr, 1))
    opac[:, :, 1] = rng.uniform(0.25, 0.75, (nzr, 1))
    gnt = np.geomspace(1e-4, 1e4, num_nt).astype(np.float32)
    pdf = np.exp(-gnt[None, :] / rng.uniform(0.1, 0.4, (nzr, 1)))
    return dict(
        opac=opac,
        cdf=(np.cumsum(pdf, 1) / pdf.sum(1, keepdims=True)).astype(
            np.float32),
        gnt=gnt, kgg=np.zeros((nzr, 32), np.float32),
        r_edges=np.linspace(0, 1.0, nr + 1).astype(np.float32),
        z_edges=np.linspace(0, 1.0, nz + 1).astype(np.float32),
        log0=float(np.log(e_ph[0])), dlog=float(np.log(e_ph[1] / e_ph[0])),
    )


def _run_jax(ph, tab, seeds, max_iters, inline):
    ktab, dims = fp2.build_kernel_tables(
        *(jnp.asarray(tab[k]) for k in ("opac", "kgg", "cdf", "gnt",
                                        "r_edges", "z_edges")),
        tab["log0"], tab["dlog"], 0.0, 1.0, win_z=fp2.WIN_Z)
    out = fp2.flight_step_v2(
        *(jnp.asarray(ph[k]) for k in FIELDS), ktab, jnp.asarray(seeds),
        dims=dims, nz=NZ, nr=NR, pair_switch=False, inline_scatter=inline,
        weight_floor=1e-10, max_iters=max_iters, max_tries=64,
        interpret=True, win_z=fp2.WIN_Z)
    return [np.asarray(o) for o in out]


def _run_port(ph, tab, seeds, max_iters, inline, fn=None):
    t = torch.as_tensor
    tables = flight.build_flight_tables(
        t(tab["opac"]), t(tab["cdf"]), t(tab["gnt"]), t(tab["r_edges"]),
        t(tab["z_edges"]), tab["log0"], tab["dlog"],
        u_edges=t(flight.guide_u_edges()))
    return (fn or flight.flight_step_reference)(
        *(t(ph[k]) for k in FIELDS), tables, t(seeds), nz=NZ, nr=NR,
        weight_floor=1e-10, max_iters=max_iters, max_tries=64,
        inline_scatter=inline)


def _assert_sums(res, jo, tol, e_scale):
    """The rules of test_torch_flight._assert_sums: edep to ``tol`` of its
    scale, prdep to ``tol`` of c x edep, the energy sums to ``tol`` of the
    input energy."""
    ed_j = jo[20][0]
    np.testing.assert_allclose(res.tally[0].numpy(), ed_j, rtol=tol,
                               atol=tol * np.abs(ed_j).max())
    c_light = float(np.float32(2.9979245620e10))
    err = np.abs(res.tally[1].numpy() - jo[20][1])
    assert np.all(err <= tol * (c_light * np.abs(ed_j) + np.abs(jo[20][1])))
    for name, pos in (("ekill", 16), ("esct", 17), ("epair", 18)):
        np.testing.assert_allclose(float(getattr(res, name)), float(jo[pos]),
                                   rtol=tol, atol=tol * e_scale,
                                   err_msg=name)


@pytest.mark.parametrize("inline", [True, False])
def test_windowed_flight_matches_pallas_interpret(inline):
    """40x30 zones, 4 zone-sorted tiles. One iteration lane for lane:
    integers exact (FLAG_WINDOW lanes included, and there are some),
    floats rtol 1e-5, tallies and sums to 1e-5 of their scale. Then 64
    iterations: >= 99% identical lanes, sums to 1e-3."""
    assert flight.window_z(NZ, NR) == fp2.WIN_Z == flight.WIN_Z
    assert flight.FLAG_WINDOW == fp2.FLAG_WINDOW
    ph = _sorted(_photons(4 * fp2.TILE, seed=1))
    tab = _tables(2)
    seeds = np.random.default_rng(3).integers(-2**31, 2**31, 4).astype(
        np.int32)
    e_scale = float(ph["w"].sum())
    jo = _run_jax(ph, tab, seeds, 1, inline)
    res = _run_port(ph, tab, seeds, 1, inline)
    for name, pos in INTS.items():
        np.testing.assert_array_equal(
            getattr(res, name).numpy().astype(np.int64),
            jo[pos].astype(np.int64), err_msg=name)
    for name, pos in FLOATS.items():
        np.testing.assert_allclose(getattr(res, name).numpy(), jo[pos],
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    n_win = int((res.flag == flight.FLAG_WINDOW).sum())
    assert n_win > 0
    assert res.it_used == int(jo[15])
    _assert_sums(res, jo, 1e-5, e_scale)

    jo = _run_jax(ph, tab, seeds, 64, inline)
    res = _run_port(ph, tab, seeds, 64, inline)
    same = np.ones(ph["e"].shape[0], bool)
    for name, pos in INTS.items():
        same &= (getattr(res, name).numpy().astype(np.int64)
                 == jo[pos].astype(np.int64))
    assert same.mean() >= 0.99, same.mean()
    assert int((res.flag == flight.FLAG_WINDOW).sum()) > n_win
    _assert_sums(res, jo, 1e-3, e_scale)


def test_window_base_rule():
    """The base block is the tile's smallest zone of a live lane with
    census distance left, // WIN_Z, clipped so that its window ends on the
    zone-padded grid (11 blocks at 40x30); a tile without such a lane
    takes the grid's last zone."""
    n = 4 * flight.TILE
    jz = torch.zeros(n, dtype=torch.int32)
    kr = torch.zeros(n, dtype=torch.int32)
    alive = torch.ones(n, dtype=torch.bool)
    dcen = torch.ones(n)
    jz[: flight.TILE] = 9          # tile 0: zone 270 -> block 2
    jz[flight.TILE:2 * flight.TILE] = 39   # tile 1: zone 1170 -> block 9
    jz[2 * flight.TILE] = 0        # tile 2: zone 0 on a dead lane ...
    alive[2 * flight.TILE] = False
    jz[2 * flight.TILE + 1:3 * flight.TILE] = 20   # ... else zone 600 -> 4
    dcen[3 * flight.TILE:] = 0.0   # tile 3: no flight left -> zone 1199
    kr[3 * flight.TILE:] = 5       # (zone 5 would give block 0)
    base = flight.window_base(jz, kr, alive, dcen, NZ, NR, flight.WIN_Z)
    assert base.tolist() == [2, 9, 4, 9]
    jz[flight.TILE:2 * flight.TILE] = 40   # off the grid: clipped to 39
    assert flight.window_base(jz, kr, alive, dcen, NZ, NR,
                              flight.WIN_Z).tolist() == [2, 9, 4, 9]
    assert flight.window_z(32, 32) == 0 and flight.window_z(33, 32) == 128
    with pytest.raises(NotImplementedError):
        flight.window_z(128, 2)


def test_recombined_window_tallies_add_every_window_at_its_base():
    """The wrapper's recombination of per-block window partials (n_blocks,
    2, 2*win_z) into (2, nzr): each window's sum lands at base * win_z + j
    (float64 check), and two calls are bitwise equal."""
    rng = np.random.default_rng(5)
    n_tiles, blocks, win_z, nzr = 6, 8, 128, 1200
    part = torch.as_tensor(rng.uniform(0, 1, (n_tiles * blocks, 2, 256)),
                           dtype=torch.float32)
    base = torch.as_tensor([0, 3, 9, 8, 5, 0], dtype=torch.int32)
    part.reshape(n_tiles, blocks, 2, 256)[2, :, :, 48:] = 0.0  # past nzr
    part.reshape(n_tiles, blocks, 2, 256)[3, :, :, 176:] = 0.0
    got = flight._recombine_windows(part, base, win_z, nzr)
    want = np.zeros((2, 11 * win_z))
    p64 = part.double().numpy().reshape(n_tiles, blocks, 2, 256).sum(1)
    for t in range(n_tiles):
        b = int(base[t]) * win_z
        want[:, b:b + 256] += p64[t]
    np.testing.assert_allclose(got.numpy(), want[:, :nzr], rtol=1e-6)
    assert torch.equal(got, flight._recombine_windows(part, base, win_z,
                                                      nzr))


def _large_sim(**kw):
    return pex.small_corona(nz=NZ, nr=NR, nst=3000, n_slots=8192, num_nt=40,
                            n_vol=32, nphfield=32, max_flight_iters=64,
                            device="cpu", **kw)


def test_window_freezes_fly_on_next_round(monkeypatch):
    """In transport_step a FLAG_WINDOW lane is neither leak nor scatter:
    it enters the next round alive with its state unchanged, under its
    tile's new window; there the lanes that the window now holds fly on
    (they move or are absorbed), until no lane is frozen. The step's
    n_window counts the freezes."""
    rounds = []
    launch = flight.flight_step

    def recorded(*a, **k):
        res = launch(*a, **k)
        rounds.append((a, flight.window_z(k["nz"], k["nr"]), res))
        return res

    monkeypatch.setattr(flight, "flight_step", recorded)
    sim = _large_sim(seed=1)
    out = sim.step()
    assert len(rounds) >= 2 and all(wz == flight.WIN_Z for _, wz, _ in rounds)
    n_frozen = 0
    for (_, _, res), (args, _, nxt) in zip(rounds, rounds[1:]):
        frozen = res.flag == flight.FLAG_WINDOW
        n_frozen += int(frozen.sum())
        assert bool(args[11][frozen].all())          # alive
        for pos, name in ((0, "e"), (1, "w"), (3, "r"), (4, "z"), (5, "mu"),
                          (8, "dcen"), (9, "jz"), (10, "kr")):
            assert torch.equal(args[pos][frozen], getattr(res, name)[frozen])
        flew = frozen & (nxt.flag != flight.FLAG_WINDOW)
        assert bool(flew.any())
        assert bool(torch.all((nxt.w[flew] != res.w[flew])
                              | (nxt.dcen[flew] != res.dcen[flew])))
    assert not bool(torch.any(rounds[-1][2].flag == flight.FLAG_WINDOW))
    assert int(out.tallies.n_window) == n_frozen > 0


def test_large_grid_steps_match_reference_pallas_path(monkeypatch):
    """small_corona at 40x30 (the reference test's size and seed), 2 steps:
    the port on the CPU through the zone sort and the windowed plain
    version, the reference with pallas_tracking="on" (interpret mode).
    The reference test's bounds: audit < 2e-3 on both, escaped and census
    within 0.6 relative, mean Te within 10%."""
    sorts, modes = [], []
    sort, reference = driver.zone_sort, flight.flight_step_reference

    def counted_sort(*a, **k):
        sorts.append(a[1:])
        return sort(*a, **k)

    def counted_reference(*a, **k):
        modes.append(flight.window_z(k["nz"], k["nr"]))
        return reference(*a, **k)

    monkeypatch.setattr(driver, "zone_sort", counted_sort)
    monkeypatch.setattr(flight, "flight_step_reference", counted_reference)
    psim = _large_sim(seed=4)
    for _ in range(2):
        psim.step()
    a_p, te_p = psim.energy_audit(), psim.state.zones.tea.numpy()
    assert sorts == [(NZ, NR, flight.WIN_Z)] * 2
    assert modes and set(modes) == {flight.WIN_Z}
    assert int(psim.last_outputs.tallies.n_window) > 0

    jsim = jex.small_corona(nz=NZ, nr=NR, nst=3000, n_slots=8192, num_nt=40,
                            n_vol=32, nphfield=32, max_flight_iters=64,
                            seed=4)
    jsim = jsim.with_config(dataclasses.replace(
        jsim.cfg, run=dataclasses.replace(jsim.cfg.run,
                                          pallas_tracking="on")))
    for _ in range(2):
        jsim.step()
    a_j, te_j = jsim.energy_audit(), np.asarray(jsim.state.zones.tea)
    assert abs(a_p["balance"] - 1.0) < 2e-3, a_p
    assert abs(a_j["balance"] - 1.0) < 2e-3, a_j
    for q in ("escaped", "census"):
        assert abs(a_p[q] - a_j[q]) / max(abs(a_j[q]), 1e-300) < 0.6, (
            q, a_p[q], a_j[q])
    assert np.all(np.isfinite(te_p))
    assert abs(te_p.mean() - te_j.mean()) / te_j.mean() < 0.1


def test_volume_em_in_zone_chunks_matches_reference(monkeypatch):
    """volume_em over 12x11 zones in chunks of 25 zones (more zones than
    one chunk, and than the reference's zone_chunk of 64) against the JAX
    volume_em at 1e-5, and against the port's single-chunk result. The
    reference flushes float32 denormals, so the port's runs do too here
    (ROADMAP C: a few zones' emission terms are subnormal)."""
    grid = dict(nz=12, nr=11, num_nt=50, n_vol=64, nphfield=64, n_gg=32,
                n_ref=100, nmu=4)
    tp = ptables.build_tables(pcfg.GridConfig(**grid), 1e15)
    tj = jtables.build_tables(jcfg.GridConfig(**grid), 1e15)
    rng = np.random.default_rng(6)
    sh = (12, 11)
    z = dict(tea=rng.uniform(5.0, 300.0, sh), n_e=10.0 ** rng.uniform(8, 11, sh),
             B=rng.uniform(1.0, 300.0, sh), amxwl=rng.uniform(0.2, 1.0, sh),
             gmin=rng.uniform(5.0, 50.0, sh), gmax=rng.uniform(1e3, 1e5, sh),
             p_nth=rng.uniform(2.0, 3.0, sh), f_pair=rng.uniform(0, 0.1, sh),
             vol=rng.uniform(0.01, 0.1, sh), surf=rng.uniform(0.1, 1.0, sh),
             lmin=np.full(sh, 0.3))
    z = {k: v.astype(np.float32) for k, v in z.items()}
    fj = jed.init_f_nt(tj.gnt, *(jnp.asarray(z[k]) for k in (
        "tea", "amxwl", "gmin", "gmax", "p_nth")))
    names = ("tea", "n_e", "B", "amxwl", "vol", "surf", "lmin")
    t = torch.as_tensor

    def port():
        return pem.volume_em(tp.e_ph, tp.gnt, t(np.array(fj)),
                             *(t(z[k]) for k in names), torch.tensor(3.3e3),
                             punits.make_scales(1e15, 1e15, 1e50),
                             f_pair=t(z["f_pair"]))

    assert torch.set_flush_denormal(True)
    try:
        whole = port()
        monkeypatch.setattr(pem, "ZONE_CHUNK_ELEMS", 25 * 64 * 50)
        vp = port()
    finally:
        torch.set_flush_denormal(False)
    vj = jem.volume_em(tj.e_ph, tj.gnt, fj, *(jnp.asarray(z[k]) for k in names),
                       jnp.float32(3.3e3), tj.sync,
                       junits.make_scales(1e15, 1e15, 1e50),
                       f_pair=jnp.asarray(z["f_pair"]))
    for name in vj._fields:
        b = np.asarray(getattr(vj, name))
        for got in (getattr(vp, name), getattr(whole, name)):
            np.testing.assert_allclose(
                got.numpy(), b, rtol=1e-5,
                atol=1e-5 * 1e-3 * np.abs(b).max() + 1e-37, err_msg=name)
