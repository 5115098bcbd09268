"""The port's measurement tools at tiny sizes on the CPU: weak scaling on
1 and 2 gloo ranks, the collectives census at two photon loads, the
stratified splitting's figure of merit, the roofline byte model (against
the former bound of the flight kernel's card check) and the sourcing
micro-profile."""
import math

import numpy as np
import pytest
import torch

from compton2d_tpu_torch import (collectives, profile_sourcing, roofline,
                                 strat_fom, weak_scaling)
from compton2d_tpu_torch.examples import small_corona
from compton2d_tpu_torch.transport import flight

torch.set_num_threads(2)

TINY = dict(nz=3, nr=2, num_nt=40, n_vol=32, nphfield=32, t_const=False)


def test_weak_scaling_on_one_and_two_gloo_ranks():
    res = weak_scaling.run((1, 2), "cpu", TINY, slots=2048, nst=300,
                           warm=1, steps=2, threads=1)
    rows = res["rows"]
    assert [r["ranks"] for r in rows] == [1, 2]
    assert all(r["backend"] == "gloo" for r in rows)
    assert rows[0]["efficiency"] == 1.0
    for r in rows:
        assert r["step_s"] > 0.0 and r["histories_per_s"] > 0.0
        assert abs(r["balance"] - 1.0) < 2e-3
        assert len(r["comm_s_per_step"]) == r["ranks"]


def test_collective_bytes_do_not_depend_on_the_photon_load():
    """2 gloo ranks, pairs and the zone farm on, at 1x and 2x the slots
    and photons a rank: every step sends the same exchanges of the same
    bytes, on both ranks, at both loads."""
    shape = dict(TINY, pair_switch=True)
    res = collectives.run(2, "cpu", "gloo", 2, shape, (1, 2), 2048, 300,
                          threads=1)
    assert res["constant"]
    one, two = res["per_load"][1], res["per_load"][2]
    assert one["steps_equal"] and two["steps_equal"]
    assert one["bytes_per_step"] == two["bytes_per_step"]
    assert one["bytes_per_step"][0] > 0
    assert one["sizes"] == two["sizes"]
    assert res["photon_soa_bytes_never_sent"][1] == \
        2 * res["photon_soa_bytes_never_sent"][0]


def test_step_exchanges_need_a_mesh_and_clear_the_log():
    sim = small_corona(**TINY, nst=300, n_slots=2048, device="cpu")
    with pytest.raises(AttributeError):
        collectives.step_exchanges(sim, 1)
    s = collectives.summary([[8, 16], [8, 16]])
    assert s == {"exchanges_per_step": [2, 2], "bytes_per_step": [24, 24],
                 "sizes": [8, 16], "steps_equal": True}
    assert not collectives.summary([[8], [16]])["steps_equal"]


def test_strat_fom_runs_a_few_steps():
    sizes = dict(nz=4, nr=2, n_slots=8192, num_nt=160, n_vol=64,
                 nphfield=64)
    res = strat_fom.compare(3, 1500, "cpu", **sizes)
    labels = [r[0] for r in strat_fom.RUNS]
    assert set(res["wall_s"]) == set(labels)
    assert all(w > 0.0 for w in res["wall_s"].values())
    assert len(res["bands"]) == 7
    on = labels[1]
    n_on = sum(b[f"n[{on}]"] for b in res["bands"])
    assert n_on > 0
    for b in res["bands"]:
        s = b[f"sigma_rel[{on}]"]
        assert s is None or (0.0 < s <= 1.0)
        if b[f"n[{labels[0]}]"]:
            assert b[f"fom_ratio[{labels[0]}/off]"] == pytest.approx(1.0)


def test_band_errors_of_known_records():
    """One record of weight w in a band: sigma_rel 1; two equal: 1/sqrt(2);
    FOM = 1 / (sigma_rel^2 t)."""
    ev = np.zeros((3, 7))
    ev[:, 1] = 3.0 / 66.0          # 3 keV after a Doppler factor near 66
    ev[:, 2] = 1.0
    ev[:, 5] = -1.0                # toward the observer
    res = strat_fom.band_errors(ev, 2.5e15, 2.0)
    soft = res[1]
    assert soft["n"] == 3
    assert soft["sigma_rel"] == pytest.approx(1.0 / math.sqrt(3.0))
    assert soft["fom"] == pytest.approx(3.0 / 2.0)
    assert res[0]["n"] == 0 and res[0]["fom"] == 0.0


def _former_bound(photons, tables, res, nz, nr, pairs=False):
    """The flight kernel's bound as the card check computed it before the
    roofline module held it (the same formula, kept here as written)."""
    PEAK_BYTES_S, PEAK_F32_S = 3.35e12, 67e12
    OPS_FLY, OPS_SCT_A, OPS_SCT_B, OPS_GG = 200, 20, 40, 15
    n = photons["e"].shape[0]
    nzr = nz * nr
    table_elems = sum(t.numel() for t in (
        tables.sig, tables.kap, tables.cdf, tables.guide, tables.gm1,
        tables.r_edges, tables.z_edges) + ((tables.kgg,) if pairs else ()))
    n_tiles = n // flight.TILE
    bytes_in = 4 * (12 * n + n_tiles + table_elems)
    bytes_out = 4 * (20 * n + 2 * nzr) + 8 * res.iglog.numel()
    live = photons["alive"] & (photons["dcen"] > 0.0)
    scatters = int(res.sct_cnt[live].sum())
    flights = int(live.sum()) + scatters
    ops = ((OPS_FLY + (OPS_GG if pairs else 0)) * flights
           + (OPS_SCT_A + OPS_SCT_B) * scatters)
    t_bytes = (bytes_in + bytes_out) / PEAK_BYTES_S
    t_ops = ops / PEAK_F32_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_in + bytes_out, "ops": ops}


def _kernel_inputs(nz, nr, n, n_vol, num_nt, n_gg, seed=0):
    """Random photons and zone tables (plain-version inputs on the CPU)."""
    from compton2d_tpu_torch.physics.electron_dist import gnt_grid
    from compton2d_tpu_torch.tables import e_field_grid, e_gg_grid

    rng = np.random.default_rng(seed)
    nzr = nz * nr
    e_ph = e_field_grid(n_vol).astype(np.float32)
    gnt = gnt_grid(num_nt).astype(np.float32)
    sig = rng.uniform(1.0, 10.0, (nzr, 1)) / (1.0 + e_ph[None, :] / 511.0)
    kap = rng.uniform(0.0, 0.05, (nzr, n_vol))
    cdf = np.sort(rng.uniform(0.0, 1.0, (nzr, num_nt)), axis=1)
    cdf[:, 0], cdf[:, -1] = 0.0, 1.0
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a)).to(dt)
    e_gg = e_gg_grid(n_gg).astype(np.float32)
    tables = flight.build_flight_tables(
        t(np.stack([sig, kap], axis=-1)), t(cdf), t(gnt),
        t(np.linspace(0.0, 1.0, nr + 1)), t(np.linspace(0.0, 1.0, nz + 1)),
        float(np.log(e_ph[0])), float(np.log(e_ph[1] / e_ph[0])),
        u_edges=torch.as_tensor(flight.guide_u_edges()),
        kgg_zone=t(rng.uniform(0.5, 3.0, (nzr, n_gg))),
        e_gg_log0=float(np.log(e_gg[0])),
        e_gg_dlog=float(np.log(e_gg[1] / e_gg[0])))
    jz, kr = rng.integers(0, nz, n), rng.integers(0, nr, n)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    photons = dict(
        e=t(10.0 ** rng.uniform(-3.0, 3.5, n)), w=t(np.ones(n)),
        w0=t(np.ones(n)), r=t((kr + rng.uniform(0.01, 0.99, n)) / nr),
        z=t((jz + rng.uniform(0.01, 0.99, n)) / nz),
        mu=t(rng.uniform(-1.0, 1.0, n)), cphi=t(np.cos(phi)),
        sphi=t(np.sin(phi)), dcen=t(rng.uniform(0.01, 0.5, n)),
        jz=t(jz, torch.int32), kr=t(kr, torch.int32),
        alive=t(rng.uniform(size=n) < 0.9, torch.bool))
    seeds = t(rng.integers(-2**31, 2**31, n // flight.TILE), torch.int32)
    return photons, tables, seeds


@pytest.mark.parametrize("pairs", [False, True])
def test_roofline_bound_equals_the_former_card_bound(pairs):
    """roofline.flight_bound on the plain version's result equals the
    formula the card check held before it moved, and round_bytes counts
    the tables of the sim's own grid (kernel_bytes + the leak pass)."""
    nz, nr, n, n_vol, num_nt, n_gg = 3, 2, 2048, 32, 40, 32
    photons, tables, seeds = _kernel_inputs(nz, nr, n, n_vol, num_nt, n_gg)
    p = photons
    res = flight.flight_step_reference(
        p["e"], p["w"], p["w0"], p["r"], p["z"], p["mu"], p["cphi"],
        p["sphi"], p["dcen"], p["jz"], p["kr"], p["alive"], tables, seeds,
        nz=nz, nr=nr, weight_floor=1e-10, max_iters=8, max_tries=10,
        inline_scatter=True, pair_switch=pairs)
    got = roofline.flight_bound(photons, tables, res, nz, nr, pairs)
    assert got == _former_bound(photons, tables, res, nz, nr, pairs)
    assert got["ops"] > 0 and got["bytes"] > 0
    sim = small_corona(nz=nz, nr=nr, nst=300, n_slots=n, num_nt=num_nt,
                       n_vol=n_vol, nphfield=32, pair_switch=int(pairs),
                       device="cpu")
    assert roofline.round_bytes(sim) == roofline.kernel_bytes(
        n, nz * nr, roofline.table_elems(tables, pairs),
        n * flight.K_LOG) + roofline.leak_bytes(n)
    assert roofline.tracking_bound_ms(sim, 2.0) == pytest.approx(
        2e3 * roofline.round_bytes(sim) / roofline.PEAK_BYTES_S)


def test_profile_sourcing_times_every_component():
    res = profile_sourcing.profile("cpu", iters=1, nz=3, nr=2, nst=2000,
                                   n_slots=4096, num_nt=40, n_vol=32,
                                   nphfield=32)
    assert set(res) == {"equipartition_b", "volume_em", "zone_sigma_table",
                        "sample_planck", "compute_budget", "census_roulette",
                        "emit"}
    assert all(v > 0.0 for v in res.values())
