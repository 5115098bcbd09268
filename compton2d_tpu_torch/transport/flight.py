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
  bin-midpoint gamma-1; and the kernel's packed copy of them
  (:func:`packed_layout`), which a block stages in shared memory when
  :func:`table_placement` says they fit;
- :func:`flight_step` — the wrapper of the hand-written CUDA kernel
  ``csrc/flight.cu``: one thread per slot, in blocks sized from the
  build's occupancy (:func:`plan_block`). On a CUDA tensor it launches the
  kernel or raises; only for CPU tensors does it run the plain version.
  :func:`launch_only` prepares a launch once for timing the kernel alone;
- :func:`flight_step_reference` — the plain PyTorch version: the kernel's
  lock-step loop over all lanes with the same counter hash, so it matches
  the kernel (and ``flight_step_v2(..., interpret=True)``) lane for lane.

Both return :class:`FlightResult`, whose fields line up with the outputs
of ``flight_step_v2``.
"""
from __future__ import annotations

import ctypes
import functools
import re
import time
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from compton2d_tpu_torch import kernel_build
from compton2d_tpu_torch import telemetry as tm

TILE = 1024        # RNG tile: lane = slot % TILE, seed = seeds[slot // TILE]
K_LOG = 8          # per-lane scatter-event log depth
SCAN_S = 4         # CDF bins counted per SCT_A iteration
GUIDE_G = 512      # electron-CDF guide cells
MAX_ZONES = 1024   # the resident mode's per-warp tallies over all zones
MAX_EDGE = 127     # nz, nr each (the reference's cap is 99, general.pa)
WIN_Z = 128        # windowed mode: zones per window block, two per tile

# the kernel's blocks and shared memory (csrc/flight.cu)
BLOCK_THREADS = (128, 256, 512, 1024)   # block sizes the planner tries
SMEM_MAX = 232448          # dynamic shared memory one block may use
N_COUNT = 4                # per-warp counters (see FlightResult.counters)
# sections of the packed tables, in their order: sigma/kappa interleaved,
# kgg, the r then z edges, the CDF, the uint16 guide, gamma-1
SECTIONS = ("opac", "kgg", "edges", "cdf", "guide", "gm1")

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
# of all launches, those that read the tables from global memory (see
# table_placement)
GLOBAL_LAUNCHES = 0


def launch_counts() -> dict:
    """The launch counts above, by mode."""
    return dict(inline=LAUNCHES, strat=STRAT_LAUNCHES, pair=PAIR_LAUNCHES,
                window=WINDOW_LAUNCHES, global_tables=GLOBAL_LAUNCHES)


def reset_launch_counts() -> None:
    """Set every launch count to 0."""
    global LAUNCHES, STRAT_LAUNCHES, PAIR_LAUNCHES, WINDOW_LAUNCHES
    global GLOBAL_LAUNCHES
    LAUNCHES = STRAT_LAUNCHES = PAIR_LAUNCHES = WINDOW_LAUNCHES = 0
    GLOBAL_LAUNCHES = 0


tm.register_launches(__name__, launch_counts)

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "flight.cu"
_lib = None


class FlightTables(NamedTuple):
    """Per-step zone tables in natural layout (f32 unless noted), which
    the plain version reads, and the kernel's packed copy of them."""

    sig: torch.Tensor        # (nzr, n_vol) scattering opacity [1/L]
    kap: torch.Tensor        # (nzr, n_vol) absorption opacity [1/L]
    kgg: torch.Tensor        # (nzr, n_gg) gamma-gamma opacity [1/L]
    cdf: torch.Tensor        # (nzr, num_nt) electron CDF
    guide: torch.Tensor      # (nzr, GUIDE_G) int32 lo-counts
    gm1: torch.Tensor        # (num_nt - 1,) bin-midpoint gamma-1
    r_edges: torch.Tensor    # (nr + 1,)
    z_edges: torch.Tensor    # (nz + 1,)
    packed: torch.Tensor     # uint8 bytes in the layout of packed_layout
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
    # the kernel's per-warp counters (n // 32, N_COUNT) int32: lanes that
    # ran an iteration (lane-iterations), and the iterations in which the
    # warp ran the FLY, SCT_A and SCT_B bodies (warp passes); None from
    # the plain version
    counters: Optional[torch.Tensor] = None


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
    ``compton2d_tpu/transport/tracking.py:541``). The kernel takes no edge
    above MAX_EDGE: such a grid raises NotImplementedError here, and the
    driver runs it on the lock-step loop (``tracking.loop_iteration``), as
    the reference runs it on its XLA loop."""
    if nz > MAX_EDGE or nr > MAX_EDGE:
        raise NotImplementedError(
            f"compton2d_tpu_torch: the flight kernel takes nz, nr <= "
            f"{MAX_EDGE} (nz={nz}, nr={nr}); pallas_tracking 'off' or "
            "'auto' runs such a grid on the lock-step loop")
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


def _pad16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def packed_layout(nz: int, nr: int, n_vol: int, n_gg: int,
                  num_nt: int) -> dict:
    """{section: (byte offset, bytes)} of the packed tables: SECTIONS in
    order, each starting on 16 bytes."""
    nzr = nz * nr
    sizes = dict(opac=8 * nzr * n_vol, kgg=4 * nzr * n_gg,
                 edges=4 * (nr + nz + 2), cdf=4 * nzr * num_nt,
                 guide=2 * nzr * GUIDE_G, gm1=4 * (num_nt - 1))
    out, off = {}, 0
    for name in SECTIONS:
        out[name] = (off, sizes[name])
        off += _pad16(sizes[name])
    return out


def staged_sections(inline_scatter: bool, pair_switch: bool) -> tuple:
    """The sections a kernel mode reads: the strat modes never run SCT_A,
    and kgg is read only under pair_switch."""
    return (("opac", "edges") + (("kgg",) if pair_switch else ())
            + (("cdf", "guide", "gm1") if inline_scatter else ()))


def _smem_layout(staged: dict, tally_w: int,
                 threads: int) -> Tuple[dict, int]:
    """Byte offsets of the kernel's shared memory and its total at
    ``threads`` threads a block: the staged sections ({name: bytes}), the
    per-warp tally rows, the tally reduction's staging, the per-warp
    counters and the mbarrier (csrc/flight.cu)."""
    warps = threads // 32
    lay, off = {}, 0
    for name in SECTIONS:
        if name in staged:
            lay[name] = off
            off += _pad16(staged[name])
    for name, nbytes in (("tally", 4 * warps * 2 * tally_w),
                         ("stage", 8 * threads),
                         ("count", 4 * N_COUNT * warps), ("bar", 8)):
        lay[name] = off
        off += _pad16(nbytes)
    return lay, off


def table_placement(nz: int, nr: int, n_vol: int, n_gg: int, num_nt: int,
                    inline_scatter: bool, pair_switch: bool
                    ) -> Tuple[str, int]:
    """("shared" or "global", bytes of the sections the mode reads). A
    resident grid stages them in each block's shared memory when they fit
    beside the rest of the largest block's layout (so that the block size
    need not shrink the warps an SM holds); other grids, and the windowed
    mode, read the packed tables from global memory."""
    lay = packed_layout(nz, nr, n_vol, n_gg, num_nt)
    staged = {k: lay[k][1] for k in staged_sections(inline_scatter,
                                                    pair_switch)}
    nbytes = sum(staged.values())
    if window_z(nz, nr) == 0:
        _, total = _smem_layout(staged, nz * nr, max(BLOCK_THREADS))
        if total <= SMEM_MAX:
            return "shared", nbytes
    return "global", nbytes


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
    *, u_edges: torch.Tensor,                  # (GUIDE_G,)
) -> FlightTables:
    """Without ``kgg_zone`` the gamma-gamma table is zero (two bins); the
    kernel reads it only under ``pair_switch``. ``u_edges`` is
    :func:`guide_u_edges` on the tables' device and the logs are host
    floats: a run makes them once."""
    f32 = torch.float32
    dev = opac_zone.device
    if kgg_zone is None:
        kgg_zone = torch.zeros((opac_zone.shape[0], 2), dtype=f32,
                               device=dev)
    log0_32 = torch.tensor(float(e_gg_log0), dtype=f32)
    cdf = cdf_nt.to(f32).contiguous()
    num_nt = cdf.shape[1]
    if num_nt >= 65535:
        raise ValueError(f"num_nt={num_nt}: the packed guide holds uint16 "
                         "counts, so num_nt must be below 65535")
    # exact compare-count (the CDF need not be bitwise monotone)
    guide = torch.sum(
        cdf[:, :, None] < u_edges[None, None, :], dim=1, dtype=torch.int32
    )
    gnt32 = gnt.to(f32)
    opac = opac_zone.to(f32).contiguous()
    n_vol = opac.shape[1]
    kgg = kgg_zone.to(f32).contiguous()
    gm1 = torch.sqrt(gnt32[1:] * gnt32[:-1]).contiguous()
    r32 = r_edges.to(f32).contiguous()
    z32 = z_edges.to(f32).contiguous()
    lay = packed_layout(z32.shape[0] - 1, r32.shape[0] - 1, n_vol,
                        kgg.shape[1], num_nt)
    off, nbytes = lay[SECTIONS[-1]]
    packed = torch.zeros(_pad16(off + nbytes), dtype=torch.uint8, device=dev)
    for name, t in (("opac", opac), ("kgg", kgg),
                    ("edges", torch.cat([r32, z32])), ("cdf", cdf),
                    ("guide", guide.to(torch.uint16)), ("gm1", gm1)):
        off, nbytes = lay[name]
        packed[off:off + nbytes] = t.reshape(-1).view(torch.uint8)
    return FlightTables(
        sig=opac[:, :, 0].contiguous(),
        kap=opac[:, :, 1].contiguous(),
        kgg=kgg,
        cdf=cdf,
        guide=guide.contiguous(),
        gm1=gm1,
        r_edges=r32,
        z_edges=z32,
        packed=packed,
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
def ptxas_report(source: Path = _SOURCE) -> str:
    """One line for each flight-kernel instance of ``source``'s build:
    ptxas's registers, stack and spills."""
    txt = kernel_build.ptxas_text(source)
    out = []
    for ln in txt.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", ln)
        if entry:
            args = re.search(r"flight_kernelILb(\d)E", entry[1])
            name = (f"flight_kernel<{'true' if args[1] == '1' else 'false'}>"
                    if args else entry[1])
            out.append([name] if "flight_kernel" in entry[1] else [])
        elif out and out[-1] and ("registers" in ln or "spill" in ln):
            out[-1].append(ln.replace("ptxas info    : ", "").strip())
    return "\n".join(": ".join([k[0], "; ".join(k[1:])])
                     for k in out if k) or txt.strip()


def build(source: Path = _SOURCE) -> float:
    """Compile ``source`` (the package's ``csrc/flight.cu`` by default) if
    its hash-keyed library is missing, and load it as the kernel that
    :func:`flight_step` launches. Returns the seconds spent."""
    global _lib
    t0 = time.perf_counter()
    path = kernel_build.compile_source(source)
    if _lib is None or Path(_lib._name) != path:
        lib = ctypes.CDLL(str(path))
        for fn in ("flight_pointers_bytes", "flight_scalars_bytes"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = ctypes.c_int
        lib.flight_occupancy.argtypes = [ctypes.c_int] * 3
        lib.flight_occupancy.restype = ctypes.c_int
        lib.flight_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]
        lib.flight_launch.restype = ctypes.c_int
        built = (lib.flight_pointers_bytes(), lib.flight_scalars_bytes())
        wanted = (ctypes.sizeof(_Pointers), ctypes.sizeof(_Scalars))
        if built != wanted:
            raise RuntimeError(f"{path.name}: struct bytes {built}, the "
                               f"wrapper's {wanted}")
        _lib = lib
        plan_block.cache_clear()
    return time.perf_counter() - t0


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


_IN = ("e", "w", "w0", "r", "z", "mu", "cphi", "sphi", "dcen", "jz", "kr",
       "alive", "seeds", "base", "tables")
_OUT = ("e", "w", "r", "z", "mu", "cphi", "sphi", "dcen", "jz", "kr",
        "alive", "mode", "flag", "jn", "kn", "it", "ekill", "esct", "epair",
        "cnt", "tally", "counters", "iglog", "delog")


class _Pointers(ctypes.Structure):
    """``struct Pointers`` of csrc/flight.cu: the inputs, then the
    outputs."""

    _fields_ = ([(f"in_{k}", ctypes.c_void_p) for k in _IN]
                + [(f"out_{k}", ctypes.c_void_p) for k in _OUT])


class _Scalars(ctypes.Structure):
    """``struct Scalars`` of csrc/flight.cu."""

    _fields_ = (
        [(k, ctypes.c_int) for k in (
            "n", "nz", "nr", "n_vol", "n_gg", "num_nt", "max_iters",
            "max_tries", "inline_scatter", "pair_switch", "win_z",
            "shared_tables", "threads", "smem")]
        + [(k, ctypes.c_int * len(SECTIONS))
           for k in ("sec_off", "sec_bytes", "sec_smem")]
        + [(k, ctypes.c_int) for k in (
            "off_tally", "off_stage", "off_count", "off_bar")]
        + [(k, ctypes.c_float) for k in (
            "e_ph_log0", "e_ph_dlog", "x_ph_hi", "e_gg_log0", "e_gg_dlog",
            "x_gg_hi", "e_gg0", "weight_floor")]
    )


class BlockPlan(NamedTuple):
    shared: bool         # tables staged in shared memory
    threads: int         # threads (slots) of a block
    per_sm: int          # blocks an SM holds
    smem: int            # dynamic shared memory of a block
    lay: dict            # its offsets (_smem_layout)


@functools.lru_cache(maxsize=None)
def plan_block(nz: int, nr: int, n_vol: int, n_gg: int, num_nt: int,
               inline_scatter: bool, pair_switch: bool) -> BlockPlan:
    """The block of a launch (the loaded build's occupancy; :func:`build`
    first): of BLOCK_THREADS, the size whose blocks keep the most warps
    resident on an SM at the shared memory they need (the tables if
    :func:`table_placement` stages them, the per-warp tallies), the
    smaller on a tie."""
    win_z = window_z(nz, nr)
    placement, _ = table_placement(nz, nr, n_vol, n_gg, num_nt,
                                   inline_scatter, pair_switch)
    shared = placement == "shared"
    lay = packed_layout(nz, nr, n_vol, n_gg, num_nt)
    staged = ({k: lay[k][1] for k in staged_sections(inline_scatter,
                                                     pair_switch)}
              if shared else {})
    tally_w = 2 * win_z if win_z else nz * nr
    best = None
    for threads in BLOCK_THREADS:
        smem_lay, smem = _smem_layout(staged, tally_w, threads)
        if smem > SMEM_MAX:
            continue
        fits = _lib.flight_occupancy(int(shared), threads, smem)
        if fits < 0:
            raise RuntimeError(f"flight_occupancy: cudaError {-fits}")
        if fits and (best is None
                     or fits * threads > best.per_sm * best.threads):
            best = BlockPlan(shared, threads, fits, smem, smem_lay)
    if best is None:
        raise RuntimeError(f"flight kernel: no block fits one SM ({nz}x{nr}"
                           " zones)")
    return best


class _Prepared(NamedTuple):
    """A checked kernel launch: its C arguments and its outputs."""

    args: tuple
    outs: dict
    base: Optional[torch.Tensor]
    win_z: int
    nzr: int
    shared: bool         # the tables staged in shared memory


def _prepare(e, w, w0, r, z, mu, cphi, sphi, dcen, jz, kr, alive,
             tables: FlightTables, seeds, *, nz: int, nr: int,
             weight_floor: float, max_iters: int, max_tries: int,
             inline_scatter: bool, pair_switch: bool) -> _Prepared:
    """Check the CUDA inputs, plan the block, allocate the outputs and
    collect the kernel's arguments."""
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
        kernel_build.check(t, name, f32, (n,), dev)
    for name, t in (("jz", jz), ("kr", kr)):
        kernel_build.check(t, name, i32, (n,), dev)
    kernel_build.check(alive, "alive", torch.bool, (n,), dev)
    kernel_build.check(seeds, "seeds", i32, (n // TILE,), dev)
    lay = packed_layout(nz, nr, n_vol, n_gg, num_nt)
    off, nbytes = lay[SECTIONS[-1]]
    kernel_build.check(tables.packed, "packed", torch.uint8,
                       (_pad16(off + nbytes),), dev)
    if _lib is None:
        build()
    plan = plan_block(nz, nr, n_vol, n_gg, num_nt, bool(inline_scatter),
                      bool(pair_switch))
    # the windowed mode's base blocks; the resident mode reads none
    base = window_base(jz, kr, alive, dcen, nz, nr, win_z) if win_z else None

    def emp(dtype, *shape):
        return torch.empty(shape, dtype=dtype, device=dev)

    n_log = n if inline_scatter else 0
    tally_w = 2 * win_z if win_z else nzr
    outs = dict(
        e=emp(f32, n), w=emp(f32, n), r=emp(f32, n), z=emp(f32, n),
        mu=emp(f32, n), cphi=emp(f32, n), sphi=emp(f32, n),
        dcen=emp(f32, n), jz=emp(i32, n), kr=emp(i32, n),
        alive=emp(torch.bool, n), mode=emp(i32, n), flag=emp(i32, n),
        jn=emp(i32, n), kn=emp(i32, n), it=emp(i32, n),
        ekill=emp(f32, n), esct=emp(f32, n), epair=emp(f32, n),
        cnt=emp(i32, n), tally=emp(f32, n // plan.threads, 2, tally_w),
        counters=emp(i32, n // 32, N_COUNT),
        iglog=emp(i32, n_log, K_LOG), delog=emp(f32, n_log, K_LOG),
    )
    ins = dict(e=e, w=w, w0=w0, r=r, z=z, mu=mu, cphi=cphi, sphi=sphi,
               dcen=dcen, jz=jz, kr=kr, alive=alive, seeds=seeds, base=base,
               tables=tables.packed)
    ptrs = _Pointers(
        *[0 if ins[k] is None else ins[k].data_ptr() for k in _IN],
        *[outs[k].data_ptr() for k in _OUT])
    staged = staged_sections(inline_scatter, pair_switch)
    sc = _Scalars(
        n=n, nz=nz, nr=nr, n_vol=n_vol, n_gg=n_gg, num_nt=num_nt,
        max_iters=int(max_iters), max_tries=int(max_tries),
        inline_scatter=int(bool(inline_scatter)),
        pair_switch=int(bool(pair_switch)), win_z=win_z,
        shared_tables=int(plan.shared), threads=plan.threads, smem=plan.smem,
        off_tally=plan.lay["tally"], off_stage=plan.lay["stage"],
        off_count=plan.lay["count"], off_bar=plan.lay["bar"],
        e_ph_log0=tables.e_ph_log0, e_ph_dlog=tables.e_ph_dlog,
        x_ph_hi=float(np.float32(n_vol - 1.000001)),
        e_gg_log0=tables.e_gg_log0, e_gg_dlog=tables.e_gg_dlog,
        x_gg_hi=float(np.float32(n_gg - 1.000001)), e_gg0=tables.e_gg0,
        weight_floor=float(np.float32(weight_floor)),
    )
    for i, name in enumerate(SECTIONS):
        sc.sec_off[i], sc.sec_bytes[i] = lay[name]
        sc.sec_smem[i] = (plan.lay[name]
                          if plan.shared and name in staged else -1)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the structs are passed by pointer and live as long as the arguments
    args = (ctypes.byref(ptrs), ctypes.byref(sc), ctypes.sizeof(ptrs),
            ctypes.sizeof(sc), stream)
    return _Prepared(args, outs, base, win_z, nzr, plan.shared)


def _launch(args: tuple) -> None:
    """One launch of the loaded kernel (``flight_launch``'s arguments)."""
    rc = _lib.flight_launch(*args)
    if rc != 0:
        raise RuntimeError(f"flight kernel launch failed: cudaError {rc}")


def _result(prep: _Prepared) -> FlightResult:
    o = prep.outs
    if prep.win_z:
        tally = _recombine_windows(o["tally"], prep.base, prep.win_z,
                                   prep.nzr)
    else:
        tally = torch.sum(o["tally"], dim=0)
    return FlightResult(
        e=o["e"], w=o["w"], r=o["r"], z=o["z"], mu=o["mu"],
        cphi=o["cphi"], sphi=o["sphi"], dcen=o["dcen"], jz=o["jz"],
        kr=o["kr"], alive=o["alive"], mode=o["mode"], flag=o["flag"],
        jn=o["jn"], kn=o["kn"],
        it_used=tm.read("track.it_used", o["it"].max(), int),
        ekill=torch.sum(o["ekill"]), esct=torch.sum(o["esct"]),
        epair=torch.sum(o["epair"]), sct_cnt=o["cnt"],
        tally=tally, iglog=o["iglog"], delog=o["delog"],
        counters=o["counters"],
    )


class Launch:
    """A kernel launch prepared once: calling it launches the kernel alone
    on the same preallocated outputs (its launches are not counted);
    ``result()`` reads them as :class:`FlightResult`."""

    def __init__(self, prep: _Prepared):
        self._prep = prep

    def __call__(self) -> None:
        _launch(self._prep.args)

    def result(self) -> FlightResult:
        return _result(self._prep)


def launch_only(e, w, w0, r, z, mu, cphi, sphi, dcen, jz, kr, alive,
                tables: FlightTables, seeds, **kw) -> Launch:
    """The timing hook: checks the CUDA inputs and allocates the outputs
    once (``flight_step``'s arguments) and returns the :class:`Launch`."""
    return Launch(_prepare(e, w, w0, r, z, mu, cphi, sphi, dcen, jz, kr,
                           alive, tables, seeds, **kw))


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
    global GLOBAL_LAUNCHES
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
    prep = _prepare(e, w, w0, r, z, mu, cphi, sphi, dcen, jz, kr, alive,
                    tables, seeds, **kw)
    _launch(prep.args)
    if inline_scatter:
        LAUNCHES += 1
    else:
        STRAT_LAUNCHES += 1
    if pair_switch:
        PAIR_LAUNCHES += 1
    if prep.win_z:
        WINDOW_LAUNCHES += 1
    if not prep.shared:
        GLOBAL_LAUNCHES += 1
    return _result(prep)
