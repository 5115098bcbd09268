"""The port's flight kernel wrapper and plain version against the JAX
Pallas kernel ``flight_step_v2`` run in interpret mode, at the shapes of
``tests/test_flight_pallas2.py``, in both kernel modes (the scatter
inlined, and the strat mode where collisions freeze with FLAG_SCATTER),
with and without the gamma-gamma absorption of ``pair_switch``. Both draw
their random numbers from the same counter hash, so they agree lane for
lane."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compton2d_tpu.transport import flight_pallas2 as fp2
from compton2d_tpu_torch.transport import flight

torch.set_num_threads(2)

NZ, NR = 3, 2
E_GG0, E_GG_DLOG, N_GG = 50.0, 0.1, 32   # the kgg grid of these tests


def _inputs(nz=NZ, nr=NR, n=2 * fp2.TILE, n_vol=48, num_nt=40, sig=1.0,
            kap=0.5, theta=0.2, seed=0, dcen=5.0):
    """Zone tables and photons (test_flight_pallas2's shapes), as numpy."""
    nzr = nz * nr
    rng = np.random.default_rng(seed)
    e_ph = np.geomspace(1e-3, 1e3, n_vol)
    opac = np.zeros((nzr, n_vol, 2), np.float32)
    opac[:, :, 0] = sig * rng.uniform(0.5, 1.5, (nzr, 1))
    opac[:, :, 1] = kap * rng.uniform(0.5, 1.5, (nzr, 1))
    gnt = np.geomspace(1e-4, 1e4, num_nt).astype(np.float32)
    th = theta * rng.uniform(0.5, 2.0, (nzr, 1))
    pdf = np.exp(-gnt[None, :] / th)
    cdf = (np.cumsum(pdf, axis=1) / pdf.sum(axis=1, keepdims=True))
    phi = rng.uniform(0, 2 * np.pi, n)
    ph = dict(
        e=rng.uniform(1.0, 10.0, n).astype(np.float32),
        w=np.ones(n, np.float32),
        w0=np.ones(n, np.float32),
        r=rng.uniform(0.1, 0.9, n).astype(np.float32),
        z=rng.uniform(0.1, 0.9, n).astype(np.float32),
        mu=rng.uniform(-1, 1, n).astype(np.float32),
        cphi=np.cos(phi).astype(np.float32),
        sphi=np.sin(phi).astype(np.float32),
        dcen=np.full(n, dcen, np.float32),
        jz=rng.integers(0, nz, n).astype(np.int32),
        kr=rng.integers(0, nr, n).astype(np.int32),
        alive=rng.uniform(size=n) < 0.95,
    )
    seeds = rng.integers(-2**31, 2**31, n // fp2.TILE).astype(np.int32)
    tab = dict(
        opac=opac, cdf=cdf.astype(np.float32), gnt=gnt,
        kgg=np.zeros((nzr, N_GG), np.float32),
        r_edges=np.linspace(0, 1.0, nr + 1), z_edges=np.linspace(0, 1.0,
                                                                 nz + 1),
        log0=float(np.log(e_ph[0])), dlog=float(np.log(e_ph[1] / e_ph[0])),
    )
    return ph, tab, seeds


def _run_jax(ph, tab, seeds, max_iters, nz=NZ, nr=NR, inline=True,
             pairs=False):
    ktab, dims = fp2.build_kernel_tables(
        jnp.asarray(tab["opac"]), jnp.asarray(tab["kgg"]),
        jnp.asarray(tab["cdf"]), jnp.asarray(tab["gnt"]),
        jnp.asarray(tab["r_edges"]), jnp.asarray(tab["z_edges"]),
        tab["log0"], tab["dlog"], float(np.log(E_GG0)), E_GG_DLOG,
    )
    out = fp2.flight_step_v2(
        *(jnp.asarray(ph[k]) for k in (
            "e", "w", "w0", "r", "z", "mu", "cphi", "sphi", "dcen", "jz",
            "kr", "alive")),
        ktab, jnp.asarray(seeds), dims=dims, nz=nz, nr=nr,
        pair_switch=pairs, inline_scatter=inline, weight_floor=1e-10,
        max_iters=max_iters, max_tries=64, interpret=True,
    )
    return [np.asarray(o) for o in out], ktab, dims


def _tables_torch(tab):
    t = torch.as_tensor
    return flight.build_flight_tables(
        t(tab["opac"]), t(tab["cdf"]), t(tab["gnt"]),
        t(tab["r_edges"].astype(np.float32)),
        t(tab["z_edges"].astype(np.float32)), tab["log0"], tab["dlog"],
        kgg_zone=t(tab["kgg"]), e_gg_log0=float(np.log(E_GG0)),
        e_gg_dlog=E_GG_DLOG, u_edges=torch.as_tensor(flight.guide_u_edges()),
    )


def _run_torch(ph, tab, seeds, max_iters, nz=NZ, nr=NR, fn=None,
               inline=True, pairs=False):
    fn = fn or flight.flight_step_reference
    args = [torch.as_tensor(ph[k]) for k in (
        "e", "w", "w0", "r", "z", "mu", "cphi", "sphi", "dcen", "jz", "kr",
        "alive")]
    return fn(*args, _tables_torch(tab), torch.as_tensor(seeds), nz=nz,
              nr=nr, weight_floor=1e-10, max_iters=max_iters, max_tries=64,
              inline_scatter=inline, pair_switch=pairs)


# flight_step_v2 output positions of the FlightResult fields
_INT_POS = {"jz": 8, "kr": 9, "alive": 10, "mode": 11, "flag": 12,
            "jn": 13, "kn": 14, "sct_cnt": 19}
_FLOAT_POS = {"e": 0, "w": 1, "r": 2, "z": 3, "mu": 4, "cphi": 5,
              "sphi": 6, "dcen": 7}


def _assert_sums(res, jo, tol, e_scale):
    """Tallies and sums to ``tol`` of their scale: the two packages add
    in different orders; prdep is a signed sum of terms up to c x the
    absorbed energy, so it is held to c x edep."""
    ed_t, ed_j = res.tally[0].numpy(), jo[20][0]
    np.testing.assert_allclose(ed_t, ed_j, rtol=tol,
                               atol=tol * np.abs(ed_j).max())
    c_light = float(np.float32(2.9979245620e10))
    err = np.abs(res.tally[1].numpy() - jo[20][1])
    assert np.all(err <= tol * (c_light * np.abs(ed_j) + np.abs(jo[20][1])))
    for name, pos in (("ekill", 16), ("esct", 17), ("epair", 18)):
        np.testing.assert_allclose(float(getattr(res, name)), float(jo[pos]),
                                   rtol=tol, atol=tol * e_scale, err_msg=name)


@pytest.mark.parametrize("inline", [True, False])
def test_one_iteration_matches_pallas_interpret_lane_for_lane(inline):
    """max_iters=1: integer state exact (FLAG_SCATTER included); floats
    rtol 1e-5 (atol 1e-6 for values near zero), since XLA's and torch's
    log/exp/sqrt may differ in the last bit."""
    ph, tab, seeds = _inputs(sig=3.0)
    jo, _, _ = _run_jax(ph, tab, seeds, 1, inline=inline)
    res = _run_torch(ph, tab, seeds, 1, inline=inline)
    n_sct = int((res.flag == flight.FLAG_SCATTER).sum())
    assert (n_sct > 0) != inline   # the strat mode froze collisions
    for name, pos in _INT_POS.items():
        np.testing.assert_array_equal(
            getattr(res, name).numpy().astype(np.int64),
            jo[pos].astype(np.int64), err_msg=name)
    for name, pos in _FLOAT_POS.items():
        np.testing.assert_allclose(getattr(res, name).numpy(), jo[pos],
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    assert res.it_used == int(jo[15])
    _assert_sums(res, jo, 1e-5, float(ph["w"].sum()))


@pytest.mark.parametrize("inline", [True, False])
def test_many_iterations_agree_with_pallas_interpret(inline):
    """max_iters=64 with scatters: >= 99% of lanes with identical integer
    state (last-bit differences can flip a rare decision), tallies and
    sums to 1e-3 of their scale, identical scatter logs on those lanes. In
    the strat mode every FLAG_SCATTER lane of the reference is one here
    too, and collisions froze instead of scattering."""
    ph, tab, seeds = _inputs(sig=6.0, kap=0.05, dcen=1.0, seed=3)
    jo, _, _ = _run_jax(ph, tab, seeds, 64, inline=inline)
    res = _run_torch(ph, tab, seeds, 64, inline=inline)
    same = np.ones(ph["e"].shape[0], bool)
    for name, pos in _INT_POS.items():
        same &= (getattr(res, name).numpy().astype(np.int64)
                 == jo[pos].astype(np.int64))
    assert same.mean() >= 0.99, same.mean()
    if inline:
        assert res.sct_cnt.float().mean() > 1.0   # the scatter machine ran
    else:
        frozen = jo[_INT_POS["flag"]] == flight.FLAG_SCATTER
        assert frozen.mean() > 0.5
        np.testing.assert_array_equal(
            res.flag.numpy()[frozen], flight.FLAG_SCATTER)
        for name, pos in _FLOAT_POS.items():
            np.testing.assert_allclose(
                getattr(res, name).numpy()[frozen & same],
                jo[pos][frozen & same], rtol=1e-5, atol=1e-6, err_msg=name)
        assert int(res.sct_cnt.sum()) == 0
        # nothing is logged: the strat mode's logs have no rows
        assert res.iglog.shape[0] == res.delog.shape[0] == 0
        assert np.all(jo[21] == -1)
    if inline:
        np.testing.assert_array_equal(res.iglog.numpy()[same], jo[21][same])
    _assert_sums(res, jo, 1e-3, float(ph["w"].sum()))


def _pair_inputs(seed, **kw):
    """Photons from 10 keV to 3 MeV (below the e_gg grid, on it, above 47
    keV and above the grid) and a kgg table of order 1 per unit length,
    rising with energy and different in every zone."""
    ph, tab, seeds = _inputs(seed=seed, **kw)
    rng = np.random.default_rng(seed + 100)
    n = ph["e"].shape[0]
    ph["e"] = (10.0 ** rng.uniform(1.0, 3.5, n)).astype(np.float32)
    nzr = tab["opac"].shape[0]
    tab["kgg"] = (rng.uniform(0.2, 2.0, (nzr, 1))
                  * np.linspace(0.1, 1.0, N_GG)[None, :]).astype(np.float32)
    return ph, tab, seeds


@pytest.mark.parametrize("inline", [True, False])
def test_pair_mode_matches_pallas_interpret(inline):
    """pair_switch=True against flight_step_v2(pair_switch=True,
    interpret=True): one iteration lane for lane (integers exact, floats
    rtol 1e-5, tallies, epair and the other sums to 1e-5 of their scale),
    then 64 iterations with >= 99% identical lanes and sums to 1e-3. The
    gamma-gamma channel carries energy in both."""
    ph, tab, seeds = _pair_inputs(5, sig=2.0, kap=0.05, dcen=1.0)
    e_scale = float(ph["w"].sum())
    jo, _, _ = _run_jax(ph, tab, seeds, 1, inline=inline, pairs=True)
    res = _run_torch(ph, tab, seeds, 1, inline=inline, pairs=True)
    for name, pos in _INT_POS.items():
        np.testing.assert_array_equal(
            getattr(res, name).numpy().astype(np.int64),
            jo[pos].astype(np.int64), err_msg=name)
    for name, pos in _FLOAT_POS.items():
        np.testing.assert_allclose(getattr(res, name).numpy(), jo[pos],
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    assert float(jo[18]) > 0.01 * e_scale       # pairs took energy
    _assert_sums(res, jo, 1e-5, e_scale)

    jo, _, _ = _run_jax(ph, tab, seeds, 64, inline=inline, pairs=True)
    res = _run_torch(ph, tab, seeds, 64, inline=inline, pairs=True)
    same = np.ones(ph["e"].shape[0], bool)
    for name, pos in _INT_POS.items():
        same &= (getattr(res, name).numpy().astype(np.int64)
                 == jo[pos].astype(np.int64))
    assert same.mean() >= 0.99, same.mean()
    _assert_sums(res, jo, 1e-3, e_scale)


def test_gamma_gamma_absorption_channel():
    """The port of test_v2_gamma_gamma_absorption_channel: a strong uniform
    kgg attenuates 100 keV photons (above 47 keV, on the e_gg grid); the
    absorbed energy goes to epair, not edep, and
    sum(w) + edep + ekill + epair - 2 esct closes to 3e-4."""
    nz, nr, n = 2, 2, fp2.TILE
    ph, tab, seeds = _inputs(nz=nz, nr=nr, n=n, sig=1e-3, kap=0.0,
                             dcen=1.0)
    tab["opac"][:, :, 0] = 1e-3
    tab["opac"][:, :, 1] = 0.0
    tab["kgg"] = np.full((nz * nr, N_GG), 3.0, np.float32)
    ph["e"][:] = 100.0
    ph["alive"][:] = True
    res = _run_torch(ph, tab, seeds, 64, nz=nz, nr=nr, pairs=True,
                     fn=flight.flight_step)
    w = float(res.w.sum())
    assert w < 0.8 * n
    assert float(res.epair) > 0.1 * n
    total = (w + float(res.tally[0].sum()) + float(res.ekill)
             + float(res.epair) - 2.0 * float(res.esct))
    np.testing.assert_allclose(total, float(n), rtol=3e-4)


def test_guide_equals_reference():
    """guide[z, j] = #(cdf[z] < u_edge[j]) must equal the kernel table
    build exactly, or the bracketed electron draws diverge."""
    ph, tab, seeds = _inputs(num_nt=200)
    _, ktab, dims = _run_jax(ph, tab, seeds, 1)
    nzr = NZ * NR
    g_ref = np.asarray(ktab.guide_t)[: nzr * dims.cg_gd].reshape(nzr, -1)
    g_port = _tables_torch(tab).guide.numpy()
    np.testing.assert_array_equal(g_port, g_ref)
    np.testing.assert_array_equal(flight.guide_u_edges(), fp2.guide_u_edges())


def test_hash_and_guide_cell_match_reference():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 2**32, 10000, dtype=np.uint64).astype(np.uint32)
    ref = np.asarray(fp2._hash_u32(jnp.asarray(x))).astype(np.int64)
    got = flight.hash_u32(torch.as_tensor(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, ref)
    u = np.concatenate([rng.uniform(0, 1, 5000),
                        1.0 - np.geomspace(1e-7, 0.5, 500),
                        fp2.guide_u_edges()]).astype(np.float32)
    np.testing.assert_array_equal(
        flight.guide_cell(torch.as_tensor(u)).numpy(),
        np.asarray(fp2._guide_cell(jnp.asarray(u))),
    )


def test_energy_bookkeeping():
    """sum(w_out) + edep + ekill - 2*esct == sum(w_in) (the mirror of
    test_v2_energy_bookkeeping)."""
    ph, tab, seeds = _inputs()
    res = _run_torch(ph, tab, seeds, 64, fn=flight.flight_step)
    total = (float(res.w.sum()) + float(res.tally[0].sum())
             + float(res.ekill) - 2.0 * float(res.esct))
    # dead lanes keep their weight, so every lane's input counts
    np.testing.assert_allclose(total, float(ph["w"].sum()), rtol=2e-4)


def test_deterministic():
    ph, tab, seeds = _inputs(seed=4)
    o1 = _run_torch(ph, tab, seeds, 64, fn=flight.flight_step)
    o2 = _run_torch(ph, tab, seeds, 64, fn=flight.flight_step)
    for a, b in zip(o1, o2):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b


def test_pure_streaming_census():
    """kap=0 and sigma tiny: photons free-stream their census distance,
    flag stays NONE, dcen -> 0, straight-line z advance."""
    n = fp2.TILE
    ph, tab, seeds = _inputs(nz=2, nr=2, n=n, sig=1e-25, kap=0.0, dcen=0.3)
    tab["opac"][:] = 0.0
    tab["opac"][:, :, 0] = 1e-25
    ph["mu"][:] = 0.2
    ph["z"][:] = 0.4
    ph["r"][:] = 0.3
    ph["alive"][:] = True
    ph["jz"][:] = 0
    ph["kr"][:] = 1
    res = _run_torch(ph, tab, seeds, 64, nz=2, nr=2, fn=flight.flight_step)
    stayed = res.flag.numpy() == flight.FLAG_NONE
    assert stayed.mean() > 0.5
    np.testing.assert_allclose(res.dcen.numpy()[stayed], 0.0, atol=1e-6)
    np.testing.assert_allclose(res.z.numpy()[stayed], 0.4 + 0.2 * 0.3,
                               rtol=1e-5)
    assert float(res.tally[0].sum()) < 1e-6


def test_wrapper_rejects_bad_inputs_on_cuda_path():
    """The wrapper validates before launching: a non-CPU, non-CUDA device
    raises instead of falling back."""
    ph, tab, seeds = _inputs(n=fp2.TILE)
    args = [torch.as_tensor(ph[k]).to("meta") for k in (
        "e", "w", "w0", "r", "z", "mu", "cphi", "sphi", "dcen", "jz", "kr",
        "alive")]
    with pytest.raises(ValueError):
        flight.flight_step(*args, _tables_torch(tab), torch.as_tensor(seeds),
                           nz=NZ, nr=NR, weight_floor=1e-10, max_iters=1,
                           max_tries=64)
