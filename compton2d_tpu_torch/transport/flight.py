"""Whole-step photon flight with the Compton scatter sampler inlined.

The counterpart of ``compton2d_tpu.transport.flight_pallas2``: with the
scatter sampler inlined (``inline_scatter=True``), or with collisions
frozen as FLAG_SCATTER for the stratified sampler outside
(``inline_scatter=False``, the mode of ``SourceConfig.strat_split``);
either one with or without the gamma-gamma absorption of ``pair_switch``;
and for grids above MAX_ZONES in the windowed mode (``win_z=WIN_Z``, see
:func:`window_z`): each 1024-slot tile owns the 2*WIN_Z-zone window that
starts at its base block (:func:`window_base`), a flying lane outside it
freezes with FLAG_WINDOW for the next outer round, and the per-zone tally
is kept per window. Three pieces:

- :func:`build_flight_tables` — the per-step zone tables in their natural
  layout (the counterpart of ``build_kernel_tables``): sigma/kappa rows,
  the gamma-gamma opacity rows on the e_gg grid, the electron CDF, the
  512-cell guide ``guide[z, j] = #(cdf[z] < u_edge[j])`` and the
  bin-midpoint gamma-1;
- :func:`flight_step` — the wrapper of the hand-written CUDA kernel
  ``csrc/flight.cu``. On a CUDA tensor it launches the kernel or raises;
  only for CPU tensors does it run the plain version;
- :func:`flight_step_reference` — the plain PyTorch version: the kernel's
  lock-step loop over all lanes with the same counter hash, so it matches
  the kernel (and ``flight_step_v2(..., interpret=True)``) lane for lane.

Both return :class:`FlightResult`, whose fields line up with the outputs
of ``flight_step_v2``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

TILE = 1024        # RNG tile: lane = slot % TILE, seed = seeds[slot // TILE]
K_LOG = 8          # per-lane scatter-event log depth
SCAN_S = 4         # CDF bins counted per SCT_A iteration
GUIDE_G = 512      # electron-CDF guide cells
MAX_ZONES = 1024   # per-warp tallies must fit 48 KB of shared memory
MAX_EDGE = 127     # nz, nr each (the reference's cap is 99, general.pa)
WIN_Z = 128        # windowed mode: zones per window block, two per tile

FLAG_NONE = 0
FLAG_SCATTER = 1
FLAG_LEAK = 2
FLAG_WINDOW = 3    # windowed mode: the lane flew out of its tile's window
MODE_FLY = 0
MODE_SCT_A = 1
MODE_SCT_B = 2

_CLAMP = 0.99999999
_CLAMP_S = 0.9999999
_INV_LN2 = 1.4426950408889634
_M32 = 0xFFFFFFFF

# kernel launches made by flight_step on CUDA tensors, in the inline
# scatter mode and in the strat (FLAG_SCATTER) mode, and of those the
# launches with pair_switch on and the windowed launches (win_z > 0); the
# plain version on CPU tensors does not count
LAUNCHES = 0
STRAT_LAUNCHES = 0
PAIR_LAUNCHES = 0
WINDOW_LAUNCHES = 0

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "flight.cu"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)
_lib = None


class FlightTables(NamedTuple):
    """Per-step zone tables in natural layout (f32 unless noted)."""

    sig: torch.Tensor        # (nzr, n_vol) scattering opacity [1/L]
    kap: torch.Tensor        # (nzr, n_vol) absorption opacity [1/L]
    kgg: torch.Tensor        # (nzr, n_gg) gamma-gamma opacity [1/L]
    cdf: torch.Tensor        # (nzr, num_nt) electron CDF
    guide: torch.Tensor      # (nzr, GUIDE_G) int32 lo-counts
    gm1: torch.Tensor        # (num_nt - 1,) bin-midpoint gamma-1
    r_edges: torch.Tensor    # (nr + 1,)
    z_edges: torch.Tensor    # (nz + 1,)
    e_ph_log0: float         # f32 value of log(e_ph[0])
    e_ph_dlog: float         # f32 value of log(e_ph[1] / e_ph[0])
    e_gg_log0: float         # f32 value of log(e_gg[0])
    e_gg_dlog: float         # f32 value of log(e_gg[1] / e_gg[0])
    e_gg0: float             # exp(e_gg_log0) in f32: the grid's first point


class FlightResult(NamedTuple):
    e: torch.Tensor
    w: torch.Tensor
    r: torch.Tensor
    z: torch.Tensor
    mu: torch.Tensor
    cphi: torch.Tensor
    sphi: torch.Tensor
    dcen: torch.Tensor
    jz: torch.Tensor
    kr: torch.Tensor
    alive: torch.Tensor      # bool
    mode: torch.Tensor
    flag: torch.Tensor
    jn: torch.Tensor
    kn: torch.Tensor
    it_used: int             # max iterations over all lanes
    ekill: torch.Tensor      # () f32
    esct: torch.Tensor       # ()
    epair: torch.Tensor      # ()
    sct_cnt: torch.Tensor    # (n,) int32
    tally: torch.Tensor      # (2, nzr) [edep, prdep]
    # scatter-event logs: (n, K_LOG) with the scatter inlined; (0, K_LOG)
    # in the strat mode, which logs nothing
    iglog: torch.Tensor      # int32, -1 = empty
    delog: torch.Tensor      # f32


def guide_u_edges() -> np.ndarray:
    """The (G,) u values at guide-cell lower edges (must match
    :func:`guide_cell`)."""
    G = GUIDE_G
    j = np.arange(G)
    lin = j / G
    log = 1.0 - 2.0 ** -(1.0 + (j - G // 2) * 25.0 / (G // 2))
    return np.where(j <= G // 2, lin, log).astype(np.float32)


def guide_cell(u: torch.Tensor) -> torch.Tensor:
    """Composite 512-cell guide index for electron-CDF u: linear below
    0.5, log-spaced in (1-u) above."""
    G = GUIDE_G
    j_lin = torch.floor(u * float(G)).to(torch.int32)
    neg_l2 = -torch.log(torch.clamp_min(1.0 - u, 1e-9)) * _INV_LN2
    j_log = G // 2 + torch.floor(
        (neg_l2 - 1.0) * ((G // 2) / 25.0)
    ).to(torch.int32)
    return torch.clamp(torch.where(u < 0.5, j_lin, j_log), 0, G - 1)


def window_z(nz: int, nr: int) -> int:
    """The kernel mode of an nz x nr grid: 0 (resident tallies) up to
    MAX_ZONES zones, WIN_Z (windowed) above (the reference's rule,
    ``compton2d_tpu/transport/tracking.py:541``). Grids with an edge above
    MAX_EDGE raise NotImplementedError: the reference runs them on its XLA
    loop, which is not ported."""
    if nz > MAX_EDGE or nr > MAX_EDGE:
        raise NotImplementedError(
            f"compton2d_tpu_torch: grids with nz or nr > {MAX_EDGE} (the "
            f"reference's XLA tracking loop; nz={nz}, nr={nr}) are not "
            "ported yet")
    return 0 if nz * nr <= MAX_ZONES else WIN_Z


def window_base(jz, kr, alive, dcen, nz: int, nr: int,
                win_z: int) -> torch.Tensor:
    """(n // TILE,) int32 base block of each tile's window: the tile's
    smallest zone among its live lanes with census distance left (nzr - 1
    if it has none), // win_z, clipped so that both blocks lie on the
    zone-padded grid (flight_pallas2.py:1018-1029)."""
    nzr = nz * nr
    zid = (torch.clamp(jz, 0, nz - 1) * nr
           + torch.clamp(kr, 0, nr - 1)).reshape(-1, TILE)
    act = (alive & (dcen > 0.0)).reshape(-1, TILE)
    zmin = torch.amin(torch.where(act, zid, nzr - 1), dim=1)
    n_blocks = -(-nzr // win_z) + 1
    return torch.clamp(torch.div(zmin, win_z, rounding_mode="floor"), 0,
                       n_blocks - 2).to(torch.int32)


def build_flight_tables(
    opac_zone: torch.Tensor,   # (nzr, n_vol, 2) [sigma, kappa]
    cdf_nt: torch.Tensor,      # (nzr, num_nt)
    gnt: torch.Tensor,         # (num_nt,) gamma-1 grid
    r_edges: torch.Tensor,
    z_edges: torch.Tensor,
    e_ph_log0: float,
    e_ph_dlog: float,
    kgg_zone: Optional[torch.Tensor] = None,   # (nzr, n_gg)
    e_gg_log0: float = 0.0,
    e_gg_dlog: float = 1.0,
) -> FlightTables:
    """Without ``kgg_zone`` the gamma-gamma table is zero (two bins); the
    kernel reads it only under ``pair_switch``."""
    f32 = torch.float32
    dev = opac_zone.device
    if kgg_zone is None:
        kgg_zone = torch.zeros((opac_zone.shape[0], 2), dtype=f32,
                               device=dev)
    log0_32 = torch.tensor(float(e_gg_log0), dtype=f32)
    cdf = cdf_nt.to(f32).contiguous()
    u_edges = torch.as_tensor(guide_u_edges(), device=dev)
    # exact compare-count (the CDF need not be bitwise monotone)
    guide = torch.sum(
        cdf[:, :, None] < u_edges[None, None, :], dim=1, dtype=torch.int32
    )
    gnt32 = gnt.to(f32)
    return FlightTables(
        sig=opac_zone[:, :, 0].to(f32).contiguous(),
        kap=opac_zone[:, :, 1].to(f32).contiguous(),
        kgg=kgg_zone.to(f32).contiguous(),
        cdf=cdf,
        guide=guide.contiguous(),
        gm1=torch.sqrt(gnt32[1:] * gnt32[:-1]).contiguous(),
        r_edges=r_edges.to(f32).contiguous(),
        z_edges=z_edges.to(f32).contiguous(),
        e_ph_log0=float(np.float32(e_ph_log0)),
        e_ph_dlog=float(np.float32(e_ph_dlog)),
        e_gg_log0=float(log0_32),
        e_gg_dlog=float(np.float32(float(e_gg_dlog))),
        e_gg0=float(torch.exp(log0_32)),
    )


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------
def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """The interpret-mode counter hash on int64 tensors holding uint32."""
    x = _mul_u32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul_u32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def u01(seed_u: torch.Tensor, lane_mix: torch.Tensor, it: int,
        draw: int) -> torch.Tensor:
    """Uniform [0, 1) with a 24-bit mantissa for (seed, it, draw, lane).
    ``seed_u`` is the lane's tile seed as uint32 in int64, ``lane_mix``
    is (lane * 2246822519) mod 2^32."""
    ctr = (seed_u + ((it * 2654435761 + draw * 40503) & _M32)) & _M32
    bits = hash_u32(ctr ^ lane_mix)
    return (bits >> 8).to(torch.int32).to(torch.float32) * (2.0 ** -24)


def flight_step_reference(
    e, w, w0, r, z, mu, cphi, sphi, dcen, jz, kr, alive,
    tables: FlightTables, seeds, *, nz: int, nr: int,
    weight_floor: float, max_iters: int, max_tries: int,
    inline_scatter: bool = True, pair_switch: bool = False,
) -> FlightResult:
    """The kernel's lock-step loop over all lanes, in PyTorch. On a grid
    in the windowed mode (:func:`window_z`) a flying lane whose unclipped
    zone id lies outside its tile's window freezes with FLAG_WINDOW
    (flight_pallas2.py:437-446)."""
    n = e.shape[0]
    dev = e.device
    f32, i32 = torch.float32, torch.int32
    nzr = nz * nr
    win_z = window_z(nz, nr)
    n_vol = tables.sig.shape[1]
    n_gg = tables.kgg.shape[1]
    num_nt = tables.cdf.shape[1]
    slot = torch.arange(n, device=dev, dtype=torch.int64)
    lane_mix = ((slot % TILE) * 2246822519) & _M32
    seed_u = (seeds.to(torch.int64) & _M32)[slot // TILE]
    x_hi = float(np.float32(n_vol - 1.000001))
    x_gg_hi = float(np.float32(n_gg - 1.000001))
    wf = float(np.float32(weight_floor))
    c_light = float(np.float32(2.9979245620e10))
    pi32 = float(np.float32(np.pi))

    e, w, r, z = e.clone(), w.clone(), r.clone(), z.clone()
    mu, cphi, sphi, dcen = mu.clone(), cphi.clone(), sphi.clone(), dcen.clone()
    jz, kr = jz.to(i32).clone(), kr.to(i32).clone()
    alive = alive.to(i32)
    zi = torch.zeros(n, dtype=i32, device=dev)
    zf = torch.zeros(n, dtype=f32, device=dev)
    flag, mode, jn, kn = zi.clone(), zi.clone(), jz.clone(), kr.clone()
    scan_idx = torch.full((n,), -1, dtype=i32, device=dev)
    scan_hi, scan_cnt, tries, igam, sct_cnt = (zi.clone() for _ in range(5))
    u_e, omg = zf.clone(), zf.clone()
    gma = torch.ones(n, dtype=f32, device=dev)
    znue = torch.full((n,), 1e-3, dtype=f32, device=dev)
    ekill, esct, epair = zf.clone(), zf.clone(), zf.clone()
    tally = torch.zeros((2, nzr), dtype=f32, device=dev)
    n_log = n if inline_scatter else 0
    iglog = torch.full((n_log, K_LOG), -1, dtype=i32, device=dev)
    delog = torch.zeros((n_log, K_LOG), dtype=f32, device=dev)
    where = torch.where
    if win_z:
        win0 = (window_base(jz, kr, alive == 1, dcen, nz, nr, win_z)
                * win_z)[slot // TILE]

    it = 0
    while it < max_iters:
        live = (alive == 1) & (flag == FLAG_NONE)
        fly = live & (mode == MODE_FLY) & (dcen > 0.0)
        in_a = live & (mode == MODE_SCT_A)
        in_b = live & (mode == MODE_SCT_B)
        if not bool(torch.any(fly | in_a | in_b)):
            break
        if win_z:
            # a flying lane outside its tile's window freezes; the test
            # reads the unclipped zone id, as the kernel does
            lz = jz * nr + kr - win0
            oow = fly & ((lz < 0) | (lz >= 2 * win_z))
            flag = where(oow, FLAG_WINDOW, flag)
            fly = fly & ~oow

        def rnd(draw):
            return u01(seed_u, lane_mix, it, draw)

        zid = torch.clamp(jz * nr + kr, 0, nzr - 1).long()

        # ---- opacity lookup --------------------------------------------
        log_e = torch.log(torch.clamp_min(e, 1e-30))
        x_ph = (log_e - tables.e_ph_log0) / tables.e_ph_dlog
        x_ph = torch.clamp(x_ph, 0.0, x_hi)
        i_ph = torch.floor(x_ph).to(i32)
        f_ph = x_ph - i_ph.to(f32)
        i0 = i_ph.long()
        i1 = torch.clamp(i_ph + 1, max=n_vol - 1).long()
        sig = torch.clamp_min(
            tables.sig[zid, i0] * (1.0 - f_ph) + tables.sig[zid, i1] * f_ph,
            1e-30,
        )
        kap = tables.kap[zid, i0] * (1.0 - f_ph) + tables.kap[zid, i1] * f_ph
        if pair_switch:
            # gamma-gamma opacity on the e_gg grid, scaled down below it
            x_gg = torch.clamp((log_e - tables.e_gg_log0) / tables.e_gg_dlog,
                               0.0, x_gg_hi)
            i_gg = torch.floor(x_gg).to(i32)
            f_gg = x_gg - i_gg.to(f32)
            g0 = torch.clamp(i_gg, 0, n_gg - 1).long()
            g1 = torch.clamp(i_gg + 1, max=n_gg - 1).long()
            kgg = (tables.kgg[zid, g0] * (1.0 - f_gg)
                   + tables.kgg[zid, g1] * f_gg)
            kgg = where(e > tables.e_gg0, kgg, kgg * e / tables.e_gg0)

        # ---- flight: tau draw + geometry + event select ----------------
        u_tau = 1e-12 + rnd(0) * (1.0 - 1e-12)
        dcol = -torch.log(u_tau) / sig
        kr_c = torch.clamp(kr, 0, nr - 1).long()
        jz_c = torch.clamp(jz, 0, nz - 1).long()
        r_in, r_out = tables.r_edges[kr_c], tables.r_edges[kr_c + 1]
        z_bot, z_top = tables.z_edges[jz_c], tables.z_edges[jz_c + 1]
        eta = torch.clamp(cphi, -_CLAMP, _CLAMP)
        mu_c = torch.clamp(mu, -_CLAMP, _CLAMP)
        sin_mu = torch.sqrt(1.0 - mu_c * mu_c)
        disp = eta * r
        rsp = r * sphi
        psq = rsp * rsp
        inward = (eta < 0.0) & (psq < r_in * r_in)
        inout = where(inward, -1.0, 1.0).to(f32)
        rbnd_shell = where(inward, r_in, r_out)
        dpbsq = torch.clamp_min(rbnd_shell * rbnd_shell - psq, 1e-6)
        disbr = torch.clamp_min(inout * torch.sqrt(dpbsq) - disp, 0.0)
        trldb_r = disbr / torch.clamp_min(sin_mu, 1e-12)
        z_r = z + mu_c * trldb_r
        hits_top = z_r > z_top
        hits_bot = z_r < z_bot
        zbnd_z = where(hits_top, z_top, z_bot)
        mu_den = where(torch.abs(mu_c) > 1e-12, mu_c, 1e-12)
        f_z = torch.clamp_min((zbnd_z - z) * sin_mu / mu_den, 0.0)
        r_z = torch.sqrt(torch.clamp_min(
            r * r + f_z * f_z + 2.0 * r * f_z * eta, 0.0))
        dzb = zbnd_z - z
        trldb_z = torch.sqrt(f_z * f_z + dzb * dzb)
        hits_zplane = hits_top | hits_bot
        trldb = where(hits_zplane, trldb_z, trldb_r)
        g_jnew = where(hits_top, jz + 1, where(hits_bot, jz - 1, jz))
        g_knew = where(hits_zplane, kr, kr + inout.to(i32))
        g_rbnd = where(hits_zplane, r_z, rbnd_shell)
        g_zbnd = where(hits_zplane, zbnd_z, z_r)
        trld = torch.minimum(dcen, dcol)
        ikind = where(dcen <= dcol, 2, 3)
        hit_bnd = trldb < trld
        trld = where(hit_bnd, trldb, trld)
        ikind = where(hit_bnd, 1, ikind)

        # ---- continuous absorption --------------------------------------
        sigabs = torch.clamp_min(kap + kgg if pair_switch else kap, 1e-30)
        xabs = sigabs * trld
        ewnew = where(xabs < 100.0, w * torch.exp(-xabs), 0.0)
        deleabs = torch.clamp_min(w - ewnew, 0.0)
        if pair_switch:
            # above 47 keV the gamma-gamma share becomes pairs, not heat
            frac_heat = where(e > 47.0, kap / sigabs, 1.0)
            edep_add = where(fly, deleabs * frac_heat, 0.0)
            epair = epair + where(fly, deleabs * (1.0 - frac_heat), 0.0)
        else:
            edep_add = where(fly, deleabs, 0.0)
        u_s = 1e-7 + rnd(1) * (1.0 - 1e-7)
        tiny_abs = xabs <= 1e-5
        frac = torch.clamp((1.0 - torch.exp(-xabs)) * u_s, 0.0, 0.999999)
        sstar = where(
            tiny_abs, 0.5 * trld,
            -torch.log(torch.clamp_min(1.0 - frac, 1e-7)) / sigabs,
        )
        denom = torch.sqrt(torch.clamp_min(
            r * r + 2.0 * mu * r * sstar + sstar * sstar, 1e-20))
        wmustar = where(tiny_abs, mu, (mu * r + sstar) / denom)
        prdep_add = where(fly, deleabs * wmustar * c_light, 0.0)
        killed = fly & (ewnew <= wf * w0)
        ekill = ekill + where(killed, ewnew, 0.0)

        # ---- move -------------------------------------------------------
        on_bnd = fly & (ikind == 1)
        f_h = trld * torch.sqrt(torch.clamp_min(1.0 - mu * mu, 0.0))
        r_free = torch.sqrt(torch.clamp_min(
            f_h * f_h + r * r + 2.0 * f_h * r * cphi, 0.0))
        rnew = where(on_bnd, g_rbnd, r_free)
        znew = where(on_bnd, g_zbnd, z + trld * mu)
        rs = torch.clamp_min(rnew, 1e-20)
        cphi_n = torch.clamp((f_h + cphi * r) / rs, -1.0, 1.0)
        sphi_n = torch.clamp(sphi * r / rs, -1.0, 1.0)
        nrm = torch.sqrt(torch.clamp_min(
            cphi_n * cphi_n + sphi_n * sphi_n, 1e-12))
        cphi_n, sphi_n = cphi_n / nrm, sphi_n / nrm
        upd = fly & ~killed
        w = where(fly, where(killed, 0.0, ewnew), w)
        r = where(upd, rnew, r)
        z = where(upd, znew, z)
        cphi = where(upd, cphi_n, cphi)
        sphi = where(upd, sphi_n, sphi)
        dcen = where(upd, dcen - trld, dcen)
        alive = where(killed, 0, alive)

        # ---- flight events ----------------------------------------------
        cross = upd & (ikind == 1)
        in_dom = (g_jnew >= 0) & (g_jnew < nz) & (g_knew >= 0) & (g_knew < nr)
        jz = where(cross & in_dom, g_jnew, jz)
        kr = where(cross & in_dom, g_knew, kr)
        leak = cross & ~in_dom
        flag = where(leak, FLAG_LEAK, flag)
        jn = where(leak, g_jnew, jn)
        kn = where(leak, g_knew, kn)
        collide = upd & (ikind == 3)
        if not inline_scatter:
            # strat mode: the lane freezes after the move, as a leak does
            flag = where(collide, FLAG_SCATTER, flag)
            tally[0].index_add_(0, zid, edep_add)
            tally[1].index_add_(0, zid, prdep_add)
            it += 1
            continue
        mode = where(collide, MODE_SCT_A, mode)
        scan_idx = where(collide, -1, scan_idx)
        tries = where(collide, 0, tries)

        # ---- SCT_A: electron draw + angle + KN acceptance ---------------
        fresh = in_a & (scan_idx < 0)
        u_e = where(fresh, 1e-7 + rnd(2) * (1.0 - 2e-7), u_e)
        cell = guide_cell(u_e).long()
        lo_cnt = tables.guide[zid, cell]
        ghi = tables.guide[zid, torch.clamp(cell + 1, max=GUIDE_G - 1)]
        hi_cnt = where(cell >= GUIDE_G - 1, num_nt, ghi)
        scan_idx = where(fresh, lo_cnt, scan_idx)
        scan_cnt = where(fresh, lo_cnt, scan_cnt)
        scan_hi = where(fresh, hi_cnt, scan_hi)
        for s in range(SCAN_S):
            m = torch.clamp(scan_idx + s, 0, num_nt - 1).long()
            mvalid = in_a & (scan_idx + s < scan_hi)
            scan_cnt = scan_cnt + where(
                mvalid & (tables.cdf[zid, m] < u_e), 1, 0
            ).to(i32)
        scan_idx = where(in_a, scan_idx + SCAN_S, scan_idx)
        resolved = in_a & (scan_idx >= scan_hi)

        idx = torch.clamp(scan_cnt, 1, num_nt - 1)
        gma_new = tables.gm1[(idx - 1).long()] + 1.0
        beta_new = torch.sqrt(torch.clamp_min(
            1.0 - 1.0 / (gma_new * gma_new), 0.0))
        om = torch.clamp(2.0 * rnd(3) - 1.0, -_CLAMP_S, _CLAMP_S)
        tl_u = rnd(4)
        om = torch.clamp(
            where(tl_u > 0.5 * (1.0 - beta_new * om), -om, om),
            -_CLAMP_S, _CLAMP_S,
        )
        znu = e / 511.0
        zn = (1.0 - beta_new * om) * znu * gma_new
        zs_ = torch.clamp_min(zn, 1e-6)
        ser = 1.0 - zn * (2.0 - zn * (5.2 - zn * (13.3 - zn * (
            32.685714 - zn * (77.714286 - zn * 124.825397)))))
        z3 = zs_ * zs_ * zs_
        betz_ = 1.0 + 2.0 * zs_
        gamz = zs_ * (zs_ - 2.0) - 2.0
        full = 0.375 * (
            4.0 * zs_ + 2.0 * z3 * (1.0 + zs_) / (betz_ * betz_)
            + gamz * torch.log(betz_)
        ) / z3
        xknot = where(zn <= 0.15, ser, full)
        ok = (zn >= 1e-10) & (rnd(5) <= xknot)
        tries = where(resolved, tries + 1, tries)
        # the last candidate is force-accepted at max_tries (the kernel's
        # rule, flight_pallas2.py:722-734)
        accept = resolved & (ok | (tries >= max_tries))
        reject = resolved & ~accept
        gma = where(accept, gma_new, gma)
        omg = where(accept, om, omg)
        znue = where(accept, torch.clamp_min(zn, 1e-10), znue)
        igam = where(accept, idx, igam)
        mode = where(accept, MODE_SCT_B, mode)
        scan_idx = where(reject, -1, scan_idx)

        # ---- SCT_B: sz rejection + finish -------------------------------
        betz_b = 1.0 + 2.0 * znue
        phat = betz_b + 1.0 / betz_b
        sz = (1.0 + 2.0 * znue * rnd(6)) / betz_b
        games_t = 1.0 + (1.0 - 1.0 / torch.clamp_min(sz, 1e-7)) / znue
        ok_g = games_t * games_t <= 1.0
        tr_b = games_t * games_t - 1.0 + sz + 1.0 / sz
        finish = in_b & ok_g & (rnd(7) * phat <= tr_b)
        beta_f = torch.sqrt(torch.clamp_min(1.0 - 1.0 / (gma * gma), 0.0))
        znues = znue * sz
        cazes = torch.cos(pi32 * (2.0 * rnd(8) - 1.0))
        omege = torch.clamp(
            (omg - beta_f) / (1.0 - beta_f * omg), -_CLAMP_S, _CLAMP_S)
        games = torch.clamp(games_t, -_CLAMP_S, _CLAMP_S)
        omeges = games * omege + cazes * torch.sqrt(torch.clamp_min(
            (1.0 - omege * omege) * (1.0 - games * games), 0.0))
        omeges = torch.clamp(omeges, -_CLAMP_S, _CLAMP_S)
        znu_b = e / 511.0
        znus = (1.0 + beta_f * omeges) * gma * znues
        gams = 1.0 - (znue - znues) / torch.clamp_min(znu_b * znus, 1e-30)
        gams = torch.clamp(gams, -_CLAMP_S, _CLAMP_S)
        cazs = torch.clamp(
            torch.cos(pi32 * (2.0 * rnd(9) - 1.0)), -_CLAMP_S, _CLAMP_S)
        mu_b = torch.clamp(mu, -_CLAMP_S, _CLAMP_S)
        wmus = mu_b * gams + cazs * torch.sqrt(torch.clamp_min(
            (1.0 - gams * gams) * (1.0 - mu_b * mu_b), 0.0))
        wmus = torch.clamp(wmus, -_CLAMP_S, _CLAMP_S)
        cosd = (gams - mu_b * wmus) / torch.sqrt(torch.clamp_min(
            (1.0 - mu_b * mu_b) * (1.0 - wmus * wmus), 1e-20))
        cosd = torch.clamp(cosd, -_CLAMP_S, _CLAMP_S)
        sind = torch.sqrt(torch.clamp_min(1.0 - cosd * cosd, 0.0))
        sind = where(rnd(10) < 0.5, 1.0, -1.0).to(f32) * sind
        cphi_s = cphi * cosd - sphi * sind
        sphi_s = sphi * cosd + cphi * sind
        nrm_s = torch.sqrt(torch.clamp_min(
            cphi_s * cphi_s + sphi_s * sphi_s, 1e-12))
        w_new = w * (znus / torch.clamp_min(znu_b, 1e-30))
        d_e = where(finish, w_new - w, 0.0)
        e = where(finish, znus * 511.0, e)
        w = where(finish, w_new, w)
        mu = where(finish, wmus, mu)
        cphi = where(finish, cphi_s / nrm_s, cphi)
        sphi = where(finish, sphi_s / nrm_s, sphi)
        mode = where(finish, MODE_FLY, mode)
        esct = esct + d_e
        for k in range(K_LOG if inline_scatter else 0):
            hit = finish & (sct_cnt == k)
            iglog[:, k] = where(hit, igam, iglog[:, k])
            delog[:, k] = where(hit, d_e, delog[:, k])
        sct_cnt = where(finish, sct_cnt + 1, sct_cnt)

        # ---- per-zone tallies -------------------------------------------
        tally[0].index_add_(0, zid, edep_add + d_e)
        tally[1].index_add_(0, zid, prdep_add)
        it += 1

    return FlightResult(
        e=e, w=w, r=r, z=z, mu=mu, cphi=cphi, sphi=sphi, dcen=dcen,
        jz=jz, kr=kr, alive=alive == 1, mode=mode, flag=flag, jn=jn, kn=kn,
        it_used=it, ekill=torch.sum(ekill), esct=torch.sum(esct),
        epair=torch.sum(epair), sct_cnt=sct_cnt, tally=tally,
        iglog=iglog, delog=delog,
    )


# ---------------------------------------------------------------------------
# CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------
def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    """Build output for the current source and flags (hash-keyed)."""
    h = hashlib.sha256(_SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD_DIR / f"flight_{h.hexdigest()[:16]}.so"


def build() -> float:
    """Compile ``csrc/flight.cu`` with nvcc for sm_90a if the hash-keyed
    library is missing, and load it. Returns the seconds spent."""
    global _lib
    t0 = time.perf_counter()
    path = library_path()
    if not path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_SOURCE)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stderr}"
                )
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    if _lib is None:
        lib = ctypes.CDLL(str(path))
        lib.flight_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_int]
            + [ctypes.c_int] * 11
            + [ctypes.c_float] * 8
            + [ctypes.c_void_p]
        )
        lib.flight_launch.restype = ctypes.c_int
        lib.flight_threads_per_block.argtypes = []
        lib.flight_threads_per_block.restype = ctypes.c_int
        _lib = lib
    return time.perf_counter() - t0


def threads_per_block() -> int:
    """Threads of one kernel block: the slots of one tally partial."""
    if _lib is None:
        build()
    return _lib.flight_threads_per_block()


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _recombine_windows(part, base, win_z: int, nzr: int) -> torch.Tensor:
    """(2, nzr) tally from the windowed mode's per-block partials
    (n_blocks, 2, 2*win_z): each tile's blocks are added in block order,
    then the tiles' windows at zone base * win_z + j by a deterministic
    segment sum (no float atomics)."""
    from compton2d_tpu_torch.transport.tracking import segment_sum

    tw = 2 * win_z
    n_tiles = base.shape[0]
    part = part.reshape(n_tiles, -1, 2, tw)
    acc = part[:, 0]
    for b in range(1, part.shape[1]):
        acc = acc + part[:, b]
    loc = (base.long()[:, None] * win_z
           + torch.arange(tw, device=base.device)[None, :])
    n_seg = (-(-nzr // win_z) + 1) * win_z
    tally = segment_sum(acc.transpose(1, 2).reshape(-1, 2), loc.reshape(-1),
                        n_seg)
    return tally[:nzr].t().contiguous()


def flight_step(
    e, w, w0, r, z, mu, cphi, sphi, dcen, jz, kr, alive,
    tables: FlightTables, seeds, *, nz: int, nr: int,
    weight_floor: float, max_iters: int, max_tries: int,
    inline_scatter: bool = True, pair_switch: bool = False,
) -> FlightResult:
    """One kernel entry over all photon slots. CPU tensors run
    :func:`flight_step_reference`; CUDA tensors launch ``csrc/flight.cu``
    (built at first use) or raise. A grid above MAX_ZONES runs the
    windowed mode (:func:`window_z`); its per-tile window tallies are
    recombined here in a fixed order."""
    global LAUNCHES, STRAT_LAUNCHES, PAIR_LAUNCHES, WINDOW_LAUNCHES
    kw = dict(nz=nz, nr=nr, weight_floor=weight_floor,
              max_iters=max_iters, max_tries=max_tries,
              inline_scatter=inline_scatter, pair_switch=pair_switch)
    if e.device.type == "cpu":
        return flight_step_reference(
            e, w, w0, r, z, mu, cphi, sphi, dcen, jz, kr, alive,
            tables, seeds, **kw,
        )
    if e.device.type != "cuda":
        raise ValueError(f"flight_step: unsupported device {e.device}")
    n = e.shape[0]
    nzr = nz * nr
    n_vol = tables.sig.shape[1]
    n_gg = tables.kgg.shape[1]
    num_nt = tables.cdf.shape[1]
    if n % TILE:
        raise ValueError(f"n_slots={n} must be a multiple of {TILE}")
    win_z = window_z(nz, nr)
    if num_nt < 2 or n_vol < 2 or n_gg < 2:
        raise ValueError("tables need at least 2 energy and gamma bins")
    dev = e.device
    f32, i32 = torch.float32, torch.int32
    for name, t in (("e", e), ("w", w), ("w0", w0), ("r", r), ("z", z),
                    ("mu", mu), ("cphi", cphi), ("sphi", sphi),
                    ("dcen", dcen)):
        _check(t, name, f32, (n,), dev)
    for name, t in (("jz", jz), ("kr", kr)):
        _check(t, name, i32, (n,), dev)
    _check(alive, "alive", torch.bool, (n,), dev)
    _check(seeds, "seeds", i32, (n // TILE,), dev)
    _check(tables.sig, "sig", f32, (nzr, n_vol), dev)
    _check(tables.kap, "kap", f32, (nzr, n_vol), dev)
    _check(tables.kgg, "kgg", f32, (nzr, n_gg), dev)
    _check(tables.cdf, "cdf", f32, (nzr, num_nt), dev)
    _check(tables.guide, "guide", i32, (nzr, GUIDE_G), dev)
    _check(tables.gm1, "gm1", f32, (num_nt - 1,), dev)
    _check(tables.r_edges, "r_edges", f32, (nr + 1,), dev)
    _check(tables.z_edges, "z_edges", f32, (nz + 1,), dev)
    threads = threads_per_block()
    alive_i = alive.to(i32)
    # the windowed mode's base blocks; the resident mode reads none
    base = (window_base(jz, kr, alive, dcen, nz, nr, win_z) if win_z
            else torch.zeros(n // TILE, dtype=i32, device=dev))

    def emp(dtype, *shape):
        return torch.empty(shape, dtype=dtype, device=dev)

    n_log = n if inline_scatter else 0
    tally_w = 2 * win_z if win_z else nzr

    outs = dict(
        e=emp(f32, n), w=emp(f32, n), r=emp(f32, n), z=emp(f32, n),
        mu=emp(f32, n), cphi=emp(f32, n), sphi=emp(f32, n),
        dcen=emp(f32, n), jz=emp(i32, n), kr=emp(i32, n),
        alive=emp(i32, n), mode=emp(i32, n), flag=emp(i32, n),
        jn=emp(i32, n), kn=emp(i32, n), it=emp(i32, n),
        ekill=emp(f32, n), esct=emp(f32, n), epair=emp(f32, n),
        cnt=emp(i32, n), tally=emp(f32, n // threads, 2, tally_w),
        iglog=emp(i32, n_log, K_LOG), delog=emp(f32, n_log, K_LOG),
    )
    ptrs = [t.data_ptr() for t in (
        e, w, w0, r, z, mu, cphi, sphi, dcen, jz, kr, alive_i, seeds, base,
        tables.sig, tables.kap, tables.kgg, tables.cdf, tables.guide,
        tables.gm1, tables.r_edges, tables.z_edges,
    )] + [t.data_ptr() for t in outs.values()]
    arr = (ctypes.c_uint64 * len(ptrs))(*ptrs)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib.flight_launch(
        arr, len(ptrs), n, nz, nr, n_vol, n_gg, num_nt, int(max_iters),
        int(max_tries), int(bool(inline_scatter)), int(bool(pair_switch)),
        int(win_z), tables.e_ph_log0, tables.e_ph_dlog,
        float(np.float32(n_vol - 1.000001)), tables.e_gg_log0,
        tables.e_gg_dlog, float(np.float32(n_gg - 1.000001)), tables.e_gg0,
        float(np.float32(weight_floor)), stream,
    )
    if rc != 0:
        raise RuntimeError(f"flight kernel launch failed: cudaError {rc}")
    if inline_scatter:
        LAUNCHES += 1
    else:
        STRAT_LAUNCHES += 1
    if pair_switch:
        PAIR_LAUNCHES += 1
    if win_z:
        WINDOW_LAUNCHES += 1
        tally = _recombine_windows(outs["tally"], base, win_z, nzr)
    else:
        tally = torch.sum(outs["tally"], dim=0)
    o = outs
    return FlightResult(
        e=o["e"], w=o["w"], r=o["r"], z=o["z"], mu=o["mu"],
        cphi=o["cphi"], sphi=o["sphi"], dcen=o["dcen"], jz=o["jz"],
        kr=o["kr"], alive=o["alive"] == 1, mode=o["mode"], flag=o["flag"],
        jn=o["jn"], kn=o["kn"], it_used=int(o["it"].max()),
        ekill=torch.sum(o["ekill"]), esct=torch.sum(o["esct"]),
        epair=torch.sum(o["epair"]), sct_cnt=o["cnt"],
        tally=tally, iglog=o["iglog"],
        delog=o["delog"],
    )
