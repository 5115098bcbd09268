"""Times of the sourcing path's components at the bench shapes (the
counterpart of ``tools/profile_sourcing.py``).

Builds the bench corona (8x4 zones, 131072 slots, nst 60000, 200 x 400
tables), runs two steps so that the census is populated, and times each
component alone on that state, called as the step calls it:
``equipartition_b``, ``volume_em``, ``zone_sigma_table``,
``sample_planck`` (every slot at 0.5 keV), ``compute_budget``,
``census_roulette`` and ``emit``. On a card each time is CUDA events
around ITERS calls after WARM calls, per call; on the CPU the host clock::

  python -m compton2d_tpu_torch.profile_sourcing
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from compton2d_tpu_torch import driver
from compton2d_tpu_torch.e2e_gate import CELLS
from compton2d_tpu_torch.examples import small_corona
from compton2d_tpu_torch.physics.planck import sample_planck
from compton2d_tpu_torch.transport import sourcing

ITERS, WARM = 20, 2


def time_ms(fn, device, iters: int = ITERS, warm: int = WARM) -> float:
    """ms a call of ``fn()``: CUDA events on a card, the host clock on the
    CPU."""
    for _ in range(warm):
        fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        torch.cuda.synchronize(device)
        return t0.elapsed_time(t1) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return 1e3 * (time.perf_counter() - t0) / iters


def components(sim) -> dict:
    """{name: a call of that component on ``sim``'s state, as the step
    makes it}."""
    s, t, g, cfg, sc = sim.state, sim.tables, sim.grid, sim.cfg, sim.scales
    zones, src, dev = s.zones, sim.src_static, sim.device
    n = s.photons.n_slots
    nz, nr = cfg.grid.nz, cfg.grid.nr
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def b_field():
        return driver.equipartition_b(
            zones.ep_switch, zones.tea, zones.tna, zones.n_e, zones.f_pair,
            zones.B_field, t.gamma_bar.forward)

    def vol_em():
        return driver.volume_em(
            t.e_ph, t.gnt, zones.f_nt, zones.tea, zones.n_e, zones.B_field,
            zones.amxwl, g.vol, g.zone_surf, sim.consts.l_min, s.dt, sc,
            f_pair=zones.f_pair)

    ve = vol_em()
    ecens = torch.zeros((nz, nr), dtype=torch.float32, device=dev)

    def budget():
        return sourcing.compute_budget(
            src, ve.eloss_tot, ecens, s.ed_abs, g.area_lower, g.area_upper,
            g.area_inner, g.area_outer, s.dt, s.dt_prev, cfg.source.nst,
            cfg.source.bias_cap, sc.sigma_sb,
            dh_sentinel=bool(cfg.physics.dh_sentinel))

    bud = budget()
    draws = sourcing.draw_emit_uniforms(gen, n, dev)
    u_rr = torch.rand(n, generator=gen, device=dev)
    t_bb = torch.full((n,), 0.5, dtype=torch.float32, device=dev)
    return {
        "equipartition_b": b_field,
        "volume_em": vol_em,
        "zone_sigma_table": lambda: driver.zone_sigma_table(
            t.sigma_e, zones.f_nt, t.gnt, zones.n_e, None),
        "sample_planck": lambda: sample_planck(
            draws.planck_u4, draws.planck_rn, t_bb, src.planck_cdf),
        "compute_budget": budget,
        "census_roulette": lambda: driver.census_roulette(
            s.photons, u_rr, cfg.run.census_rr_hi, sim.consts.rr_target,
            n_reserve=bud.n_new),
        "emit": lambda: sourcing.emit(
            s.photons, draws, bud, src, g.r_edges, g.z_edges, g.zone_surf,
            ve.eps_tot, ve.eps_th, ve.eloss_th, ve.eloss_tot, t.e_ph, s.dt,
            nz, nr, c_scaled=sc.c),
    }


def profile(device="cuda", iters: int = ITERS, **shape) -> dict:
    """ms a call of each component, after two steps of the corona."""
    kw = dict(CELLS["main_path"])   # the bench corona
    kw.update(shape)
    sim = small_corona(**kw, device=device)
    sim.run(2)
    return {name: time_ms(fn, sim.device, iters)
            for name, fn in components(sim).items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=ITERS)
    args = ap.parse_args()
    res = profile(args.device, args.iters)
    print(json.dumps({"config": "small_corona 8x4, 131072 slots, nst 60000",
                      "ms": res}, indent=1))


if __name__ == "__main__":
    main()
