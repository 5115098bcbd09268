"""The port's multi-process runs on the CPU: 2 or 4 ranks over
torch.distributed with gloo, each a spawned process meeting the others
through a ``file://`` rendezvous under the test's tmp_path, every join
bounded (``parallel.distributed.run_ranks``; the rank programs are in
tests/test_torch_ranks.py). JAX runs on the 8-device virtual CPU mesh of
tests/conftest.py.

The JAX package's own sharded tests have counterparts here on the same
configurations and bounds, except that the port's ranks hold whole
1024-slot tiles (as the reference's Pallas path does,
compton2d_tpu/driver.py:1068-1075), so 4 ranks take 4096 slots where
the JAX test gives 4 devices 2048."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_ranks
from compton2d_tpu import examples as jex
from compton2d_tpu.config import InjectionConfig as JInjection
from compton2d_tpu.fp.update import fp_step as j_fp_step
from compton2d_tpu.parallel.mesh import make_photon_mesh
from compton2d_tpu.transport import sourcing as jsrc
from compton2d_tpu_torch import convert
from compton2d_tpu_torch import examples as pex
from compton2d_tpu_torch.config import InjectionConfig as PInjection
from compton2d_tpu_torch.fp.update import fp_constants
from compton2d_tpu_torch.fp.update import fp_step as p_fp_step
from compton2d_tpu_torch.io import checkpoint
from compton2d_tpu_torch.parallel import mesh as pmesh
from compton2d_tpu_torch.parallel.distributed import run_ranks
from compton2d_tpu_torch.transport import sourcing as psrc

torch.set_num_threads(2)

# (seconds) every run of ranks, its rendezvous and each collective
RANKS_TIMEOUT, INIT_TIMEOUT = 240.0, 60.0

INJECTION = dict(switch=1, distribution=2, g1=2.0, g2=1.0e3, p=2.4,
                 t_start=0.0, luminosity=1.0e38, pickup=True,
                 pickup_rate=1.0e-2)


def ranks(fn, world, *args, tmp_path):
    return run_ranks(fn, world, args, backend="gloo", device="cpu",
                     timeout_s=RANKS_TIMEOUT, init_timeout_s=INIT_TIMEOUT,
                     threads=1, rendezvous_dir=str(tmp_path))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# counterparts of the JAX package's sharded tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_step_runs_and_conserves(world, tmp_path):
    """tests/test_driver.py:69-80: 2 steps, balance within 1e-4 on every
    rank, photons alive; every rank holds n_slots / world slots and the
    same tallies."""
    res = ranks(test_torch_ranks.conserve, world, 1024 * world, 2,
                tmp_path=tmp_path)
    for r in res:
        assert r["slots"] == 1024
        assert all(abs(b - 1.0) < 1e-4 for b in r["balance"]), r["balance"]
        for step, t in enumerate(r["tallies"]):
            assert not test_torch_ranks.differing(t, res[0]["tallies"][step])
        assert not test_torch_ranks.differing(r["zones"], res[0]["zones"])
    assert sum(r["alive"] for r in res) > 0


def test_sharded_self_determinism(tmp_path):
    """tests/test_driver.py:82-93 on 4 ranks: the same seed gives the same
    ecens (and every other tally) bitwise."""
    for r in ranks(test_torch_ranks.self_determinism, 4, 4096, 3,
                   tmp_path=tmp_path):
        assert np.array_equal(r["first"]["ecens"], r["second"]["ecens"])
        assert not test_torch_ranks.differing(r["first"], r["second"])


@pytest.mark.parametrize("with_injection", [False, True])
def test_zone_shard_matches_replicated(with_injection, tmp_path):
    """tests/test_driver.py:112-165: the zone farm (Z = 6 zones on 4 ranks,
    padded to 8) against every rank solving all zones, pair physics on, 3
    steps: e_el within rtol 1e-6, zone state and tallies bitwise; with
    injection the pad zones must not inject."""
    res = ranks(test_torch_ranks.zone_shard, 4,
                INJECTION if with_injection else None, 3, tmp_path=tmp_path)
    for r in res:
        rep, shard = r[False], r[True]
        for (o_r, n_r), (o_s, n_s) in zip(rep["e_el"], shard["e_el"]):
            assert np.isclose(n_r, n_s, rtol=1e-6)
            assert np.isclose(o_r, o_s, rtol=1e-6)
        for name in ("tea", "f_nt", "n_e", "gmin", "p_nth", "f_pair"):
            assert np.array_equal(rep["zones"][name], shard["zones"][name]), \
                name
        for a, b in zip(rep["tallies"], shard["tallies"]):
            assert not test_torch_ranks.differing(a, b)
        assert not test_torch_ranks.differing(shard["zones"], res[0][True]["zones"])


def test_sharded_event_flush(tmp_path):
    """tests/test_runloop.py:63-77: each of 2 ranks writes its own records
    to pNNN_evb.dat (every record of its buffers, or counts the dropped
    ones); rank 0 alone accumulates the run outputs."""
    out_dir = str(tmp_path / "out")
    res = ranks(test_torch_ranks.event_flush, 2, out_dir, tmp_path=tmp_path)
    for rank, r in enumerate(res):
        assert r["path"] == os.path.join(out_dir, f"p{rank:03d}_evb.dat")
        assert r["written"] == sum(r["counts"]) or r["dropped"] > 0
        data = np.loadtxt(r["path"]).reshape(-1, 7)
        assert data.shape[0] == r["written"] > 0
        assert r["outputs"] == (rank == 0)


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------
def test_compute_budget_with_replicas_matches_reference():
    """compute_budget(replicas=4) with a quarter of nst, as every rank
    calls it, against the JAX function on the same inputs: rtol 1e-6,
    counts exact."""
    jsim = jex.small_corona(nz=3, nr=2, nst=3000, n_slots=4096, num_nt=50,
                            n_vol=48, nphfield=48)
    _, _, grid, src, _ = convert.from_reference(
        convert.flatten(jsim.state), convert.flatten(jsim.tables),
        convert.flatten(jsim.grid), convert.flatten(jsim.src_static),
        device="cpu")
    rng = np.random.default_rng(2)
    fas = rng.uniform(1.0, 5.0, (3, 2)).astype(np.float32)
    ecens = rng.uniform(0.0, 3.0, (3, 2)).astype(np.float32)
    jg, sc, dt = jsim.grid, jsim.scales, jsim.state.dt
    bj = jsrc.compute_budget(
        jsim.src_static, jnp.asarray(fas), jnp.asarray(ecens), jnp.zeros(2),
        jg.area_lower, jg.area_upper, jg.area_inner, jg.area_outer,
        jnp.asarray(dt), jnp.asarray(dt), 3000 // 4, 10.0, sc.sigma_sb,
        replicas=4)
    dt_t = torch.as_tensor(np.float32(dt))
    bp = psrc.compute_budget(
        src, torch.as_tensor(fas), torch.as_tensor(ecens), torch.zeros(2),
        grid.area_lower, grid.area_upper, grid.area_inner, grid.area_outer,
        dt_t, dt_t, 3000 // 4, 10.0, sc.sigma_sb, replicas=4)
    for name in bj._fields:
        a, b = _np(getattr(bp, name)), _np(getattr(bj, name))
        if b.dtype.kind == "i":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=name)
    assert int(bj.n_new) > 0


def test_fp_step_on_a_padded_zone_slice_matches_reference():
    """The FP zone farm's call on rank 1 of 2 over 3x3 zones (zones 5-8
    and one pad zone, injection on): the port's fp_step with j_row,
    slab_vol and zone_valid against the JAX fp_step with the same
    arguments (the JAX driver's slice, compton2d_tpu/driver.py:1151-1178),
    each array over the real zones (the gather drops the pad zone) within
    1e-5 of its max, incomplete zones exact, p_nth to one step of the
    refit's 0.05 grid (an argmin over near-equal misfits may pick a
    neighbour). The JAX solve turns the pad zone's distribution into NaN,
    which never finishes its substeps, so it runs all fp_max_substeps
    (256); the port's pad zone stays finite and finishes with the real
    ones (ROADMAP C)."""
    kw = dict(nz=3, nr=3, nst=2000, n_slots=4096, num_nt=50, n_vol=48,
              nphfield=48, t_const=False, seed=3)
    jsim = jex.small_corona(**kw, injection=JInjection(**INJECTION))
    psim = pex.small_corona(**kw, injection=PInjection(**INJECTION),
                            device="cpu")
    psim.step()
    n_field = psim.last_outputs.tallies.n_field.numpy()
    js, jt, jg = jsim.state, jsim.tables, jsim.grid
    state, tables, grid, _, _ = convert.from_reference(
        convert.flatten(js), convert.flatten(jt), convert.flatten(jg),
        convert.flatten(jsim.src_static), device="cpu")
    eloss_sy = np.random.default_rng(1).uniform(0.0, 1e-3, (3, 3)).astype(
        np.float32)
    mesh = pmesh.PhotonMesh(rank=1, world=2, backend="gloo",
                            device=torch.device("cpu"))
    valid = pmesh.zone_valid(mesh, 9, "cpu")
    assert valid.numpy().ravel().tolist() == [True] * 4 + [False]

    def part(x):   # the JAX driver's zslice for device 1 of 2
        x = np.asarray(x)
        flat = x.reshape((9,) + x.shape[2:])
        flat = np.concatenate([flat, flat[-1:]])[5:10]
        return flat.reshape((5, 1) + x.shape[2:])

    zj = js.zones._replace(**{f: jnp.asarray(part(getattr(js.zones, f)))
                              for f in js.zones._fields})
    zj = zj._replace(n_e=jnp.where(valid.numpy(), zj.n_e, 0.0),
                     tna=jnp.where(valid.numpy(), zj.tna, 0.0))
    zp = state.zones._replace(**{f: pmesh.zone_slice(mesh, getattr(
        state.zones, f)) for f in state.zones._fields})
    zp = zp._replace(n_e=torch.where(valid, zp.n_e, 0.0),
                     tna=torch.where(valid, zp.tna, 0.0))
    j_row = np.repeat(np.arange(3, dtype=np.float32)[:, None], 3, axis=1)
    np.testing.assert_array_equal(
        pmesh.zone_slice(mesh, torch.as_tensor(j_row)).numpy(), part(j_row))
    slab = float(np.sum(np.asarray(jg.vol))) / 3
    rj = j_fp_step(zj, jnp.asarray(part(n_field)), jt,
                   jnp.asarray(part(jg.vol)), float(jsim.cfg.grid.z_max),
                   jg.dz, js.dt, js.time, jnp.asarray(part(eloss_sy)),
                   jsim.cfg.physics, jsim.scales,
                   j_row=jnp.asarray(part(j_row)),
                   slab_vol=jnp.float32(slab),
                   zone_valid=jnp.asarray(valid.numpy()))
    rp = p_fp_step(zp, torch.as_tensor(part(n_field)), tables,
                   pmesh.zone_slice(mesh, grid.vol),
                   float(psim.cfg.grid.z_max), grid.dz, state.dt,
                   state.time, torch.as_tensor(part(eloss_sy)),
                   psim.cfg.physics, psim.scales,
                   fp_constants(tables.gnt, float(psim.cfg.grid.z_max),
                                psim.cfg.physics),
                   j_row=torch.as_tensor(part(j_row)),
                   slab_vol=torch.tensor(slab, dtype=torch.float32),
                   zone_valid=valid)
    assert 1 < int(rp.substeps) < int(rj.substeps) == 256
    assert int(rp.incomplete) == int(rj.incomplete)
    assert np.isnan(_np(rj.zones.f_nt)[4]).all()
    assert np.isfinite(_np(rp.zones.f_nt)[4]).all()
    for name in ("dt_new", "dT_max", "e_el_old", "e_el_new"):
        np.testing.assert_allclose(_np(getattr(rp, name)),
                                   _np(getattr(rj, name)), rtol=1e-5,
                                   err_msg=name)
    for name in ("tea", "n_e", "f_nt", "cdf_nt", "gmin", "gmax", "amxwl"):
        ref = _np(getattr(rj.zones, name))[:4]
        err = np.abs(_np(getattr(rp.zones, name))[:4] - ref).max()
        assert err <= 1e-5 * np.abs(ref).max(), (name, err)
    np.testing.assert_allclose(_np(rp.zones.p_nth)[:4],
                               _np(rj.zones.p_nth)[:4], atol=0.051)


# the port's slice configuration of tests/test_torch_slice.py
SLICE_CFG = dict(nz=3, nr=2, nst=3000, n_slots=4096, num_nt=50, n_vol=64,
                 nphfield=64, t_const=False)


def test_two_ranks_match_reference_on_two_devices(tmp_path):
    """The port on 2 ranks against the JAX package on a 2-device mesh
    (its Pallas path in interpret mode), 3 seeds a side, 2 steps: escaped
    and census energy and mean Te within z < 4, the standard error
    floored at 1e-3 of the reference's mean (tests/test_torch_slice.py)."""
    mesh = make_photon_mesh(jax.devices()[:2])
    jsim = jex.small_corona(**SLICE_CFG, seed=0, mesh=mesh)
    jsim = jsim.with_config(dataclasses.replace(
        jsim.cfg, run=dataclasses.replace(jsim.cfg.run,
                                          pallas_tracking="on")), mesh=mesh)
    init = jsim.state
    ref = []
    for s in (0, 1, 2):
        jsim.state = init._replace(key=jax.random.PRNGKey(s))
        jsim.run(2)
        a = jsim.energy_audit()
        ref.append([a["escaped"], a["census"],
                    float(np.mean(np.asarray(jsim.state.zones.tea)))])
    port = ranks(test_torch_ranks.observables, 2, (0, 1, 2), 2, SLICE_CFG,
                 tmp_path=tmp_path)
    assert port[0] == port[1]          # replicated after the reductions
    ref, port = np.array(ref), np.array(port[0])
    se = np.sqrt(ref.var(0, ddof=1) / 3 + port.var(0, ddof=1) / 3)
    se = np.maximum(se, 1e-3 * np.abs(ref.mean(0)))
    z = np.abs(port.mean(0) - ref.mean(0)) / se
    assert np.all(z < 4.0), (z, port.mean(0), ref.mean(0))


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------
def test_one_rank_mesh_equals_no_mesh(tmp_path):
    """A mesh of one rank (its collectives run) gives tallies, zones,
    photons and the generator bitwise equal to mesh=None over 3 steps with
    the FP solve on."""
    (r,) = ranks(test_torch_ranks.one_rank, 1, 3, tmp_path=tmp_path)
    assert r["comm_calls"] > 0
    assert r["differing"] == []


@pytest.fixture(scope="module")
def resumed_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("resume")
    return ranks(test_torch_ranks.resume, 2, str(d / "out"), 2, 2, tmp_path=d)


def test_walltime_guard_on_one_rank_stops_every_rank(resumed_run):
    """The guard tripped on rank 1 only: both ranks checkpoint and return
    False on the same step (no rank left waiting in a collective), each
    with its shard beside rank 0's file."""
    for rank, r in enumerate(resumed_run):
        assert r["completed"] is False
        assert r["ncycle"] == 2
        assert os.path.exists(checkpoint.shard_path(r["checkpoint"], rank))
    ck = resumed_run[0]["checkpoint"]
    assert checkpoint.load_meta(ck)["ncycle"] == 2


def test_resume_through_checkpoint_equals_uninterrupted(resumed_run):
    """2 + 2 steps through the checkpoint against 4: every step's tallies
    and event records, every state tensor and generator, and both ranks'
    pNNN_evb.dat files bitwise equal."""
    for r in resumed_run:
        assert r["differing"] == []
        cut, whole = r["events"]
        with open(cut, "rb") as fa, open(whole, "rb") as fb:
            assert fa.read() == fb.read()
        assert os.path.getsize(cut) > 0


def test_checkpoint_under_another_world_size_raises(resumed_run):
    """A 2-rank checkpoint does not load without the mesh, and a
    single-process one does not load under the 2-rank mesh."""
    sim = pex.small_corona(**test_torch_ranks.TINY, n_slots=2048, seed=9,
                           device="cpu")
    with pytest.raises(ValueError, match="written by 2 ranks"):
        checkpoint.load_checkpoint(resumed_run[0]["checkpoint"], sim.state)
    for r in resumed_run:
        assert "written by 1 ranks, resuming with 2" in r["refused"]


def test_exchange_reductions(tmp_path):
    """parallel.mesh on 4 ranks: float sums bitwise the rank-order sum,
    integer sums exact, max and min, and the zone farm's slices of 6 zones
    (padded to 8 with the last zone) gathered back; every rank alike."""
    res = ranks(test_torch_ranks.exchange, 4, 6, tmp_path=tmp_path)
    acc = res[0]["f"]
    for r in res[1:]:
        acc = acc + r["f"]
    ints = np.sum([r["i"] for r in res], axis=0, dtype=np.int32)
    for r in res:
        assert np.array_equal(r["sum_f"], acc)
        assert np.array_equal(r["sum_i"], ints)
        assert np.array_equal(r["max"], np.max([q["f"] for q in res], 0))
        assert np.array_equal(r["min"], np.min([q["f"] for q in res], 0))
        assert np.array_equal(r["back"], 2.0 * r["zones"])
    assert [r["valid"].ravel().tolist() for r in res] == [
        [True, True], [True, True], [True, True], [False, False]]
    assert np.array_equal(res[3]["part"], np.repeat(res[0]["zones"][-1:], 2,
                                                    axis=0))


def test_shard_photons_round_trips_the_reference_four_device_state():
    """convert.shard_photons cuts the JAX package's 4-device census after
    one step into each device's own slots, and the four shares rebuild
    the whole census; a share carried across is a port PhotonArray of
    n_slots / 4 slots."""
    mesh = make_photon_mesh(jax.devices()[:4])
    jsim = jex.small_corona(**SLICE_CFG, seed=5, mesh=mesh)
    jsim.step()
    photons = convert.flatten(jsim.state.photons)
    assert int(np.sum(photons["alive"])) > 0
    shares = [convert.shard_photons(photons, r, 4) for r in range(4)]
    for name, arr in photons.items():
        leaf = getattr(jsim.state.photons, name)
        dev = sorted(leaf.addressable_shards, key=lambda s: s.index[0].start)
        for r, s in enumerate(dev):
            np.testing.assert_array_equal(shares[r][name], np.asarray(s.data))
        np.testing.assert_array_equal(
            np.concatenate([sh[name] for sh in shares]), arr)
    flat = dict(convert.flatten(jsim.state), **{
        f"photons.{k}": v for k, v in shares[2].items()})
    state, *_ = convert.from_reference(
        flat, convert.flatten(jsim.tables), convert.flatten(jsim.grid),
        convert.flatten(jsim.src_static), device="cpu")
    assert state.photons.n_slots == 1024
    np.testing.assert_array_equal(state.photons.e.numpy(), shares[2]["e"])
    with pytest.raises(ValueError):
        convert.shard_photons(photons, 0, 3)
