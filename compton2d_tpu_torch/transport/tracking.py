"""Photon tracking: the flight kernel's outer rounds and the lock-step
flight loop, boundary leaks and reflection, the scatters outside the
kernel and the census tallies (counterpart of
``compton2d_tpu.transport.tracking``).

``transport_step`` runs one of two trackers (``TrackStatics.tracker``,
chosen by the driver from ``RunConfig.pallas_tracking``):

- ``"kernel"``: each outer round launches the flight kernel
  (``transport.flight``) over all slots; a kernel entry ends only at
  census, leak, a collision in the strat mode, or the iteration budget.
  Lanes frozen with FLAG_LEAK are handed to :func:`_leak`; with the
  scatter inlined, the kernel's per-lane scatter logs are histogrammed
  into e_ic / n_esp; under stratified splitting the lanes frozen with
  FLAG_SCATTER go through :func:`apply_scatter`;
- ``"loop"``: the reference's lock-step loop (``_flight_phase``): each
  iteration (:func:`loop_iteration`) moves every live slot by one flight
  leg in plain PyTorch, on any grid and any slot count, with the leaks
  through :func:`_leak` and the collisions through :func:`apply_scatter`
  (the rejection sampler ``scatter.scatter``, or the stratified one).

:func:`_leak` does the escape tallies, Compton reflection off the lower
boundary and the outer disk, and the event records; a lane reflected at
the lower boundary stays alive and flies on. The reference's one-hot
matmul tallies (``zone_accum`` / ``hist2d_accum``) and row lookups
(``_zone_rows``) become deterministic segment sums and gathers, and its
compare-count binning and bisections become ``searchsorted``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from compton2d_tpu_torch import telemetry as tm
from compton2d_tpu_torch.constants import C_LIGHT
from compton2d_tpu_torch.state import EventBuffer, PhotonArray, Tallies
from compton2d_tpu_torch.transport import flight, geometry
from compton2d_tpu_torch.transport.scatter import (
    ScatterDraws,
    draw_scatter_uniforms,
    scatter,
    scatter_stratified,
)


@dataclass(frozen=True)
class TrackStatics:
    """Static tracking configuration."""

    nz: int
    nr: int
    # Compton reflection (PhysicsConfig.cr_sent): 0 none, 1 lower
    # boundary, 2 outer disk, 3 both, 4 mirror at the lower boundary
    cr_sent: int = 0
    rmin_positive: bool = False
    max_iters: int = 512
    max_scatter_tries: int = 64
    weight_floor: float = 1.0e-10
    upper_escape_mu_cut: float = 0.98   # imcleak2d.f:303 event filter
    spec_switch: int = 0                # imcleak2d.f:53-58
    # gamma-gamma absorption in the flight kernel (PhysicsConfig.pair_switch)
    pair_switch: bool = False
    # stratified tail splitting (SourceConfig.strat_split): collisions
    # leave the kernel and apply_scatter splits the tail above gnt index
    # strat_icut into strat_copies copies
    strat_split: bool = False
    strat_icut: int = 0
    strat_p_min: float = 1.0e-6
    strat_p_max: float = 0.5
    strat_copies: int = 1
    # "kernel": the flight kernel's outer rounds; "loop": the lock-step
    # flight loop (see the module docstring)
    tracker: str = "kernel"


class TrackContext(NamedTuple):
    """The tracker's inputs (fields as in the reference): those that the
    configuration and the tables fix are made once a run (the driver's
    ``step_constants``), the zone rows and the clock each step."""

    r_edges: torch.Tensor     # (nr+1,) f32
    z_edges: torch.Tensor     # (nz+1,) f32
    opac_zone: torch.Tensor   # (nz*nr, n_vol, 2) [sigma, kappa] [1/L]
    cdf_nt: torch.Tensor      # (nz*nr, num_nt)
    gnt: torch.Tensor         # (num_nt,)
    e_ph_log0: float
    e_ph_dlog: float
    e_gg_log0: torch.Tensor
    e_gg_dlog: torch.Tensor
    e_field_log0: torch.Tensor
    e_field_dlog: torch.Tensor
    hu: torch.Tensor
    mu_edges: torch.Tensor
    lc_lo: torch.Tensor
    lc_hi: torch.Tensor
    tbbl_pos: torch.Tensor    # (nr,) bool
    time: torch.Tensor        # () f32 [s]
    dt: torch.Tensor          # () f32 [s]
    inv_c: float              # seconds per scaled length
    # the flight kernel's guide-cell edges (flight.guide_u_edges) on the
    # device, and e_gg_log0, e_gg_dlog as host floats: its launch takes
    # floats, the device math above 0-d tensors
    guide_u: torch.Tensor
    e_gg_host: Tuple[float, float]
    strat_frac: torch.Tensor  # strat_fractions(strat_copies)
    # (nz*nr,) 1/(n_eff sigma_T L F_tot), the stratified-scatter
    # normalizer; needed only under strat_split
    inv_nsigt: Optional[torch.Tensor] = None
    # (nz*nr, n_gg) gamma-gamma opacity [1/L] on the e_gg grid; read only
    # under pair_switch
    kgg_zone: Optional[torch.Tensor] = None
    # the reflection tables, read only with cr_sent != 0: the energy grid
    # (n_ref,) and P_ref / w_abs transposed to (n_in, n_out), so that the
    # sampler searches along one input row (the reference's p_ref_t and
    # w_abs_t)
    e_ref: Optional[torch.Tensor] = None
    p_ref_t: Optional[torch.Tensor] = None
    w_abs_t: Optional[torch.Tensor] = None


def strat_fractions(copies: int, device=None) -> torch.Tensor:
    """(2, M, 1) f32: m / M and (m + 1) / M, the bounds of the sub-strata
    of the M = max(copies, 1) tail copies of a stratified scatter."""
    m_cp = max(int(copies), 1)
    return torch.tensor([[m / m_cp for m in range(m_cp)],
                         [(m + 1.0) / m_cp for m in range(m_cp)]],
                        dtype=torch.float32, device=device)[..., None]


class LeakDraws(NamedTuple):
    """The uniforms (n,) of one round's reflections, in the reference's
    streams: the lower boundary's CDF and energy draws (its k1 and k2),
    the outer disk's (fold_in(k1, 1), fold_in(k2, 1)) and the disk
    photon's direction (fold_in(k1, 2))."""

    u_cdf_low: torch.Tensor
    u_e_low: torch.Tensor
    u_cdf_disk: torch.Tensor
    u_e_disk: torch.Tensor
    u_mu: torch.Tensor


def draw_leak_uniforms(gen: torch.Generator, n: int, device) -> LeakDraws:
    """The five uniforms of a round with a leak, in a fixed order."""
    return LeakDraws(*torch.rand((5, n), generator=gen, device=device))


def sample_reflection(e, w, u_cdf, u_e, e_ref, p_ref_t, w_abs_t):
    """Compton reflection of photons (e, w) off cold matter
    (imcleak2d.f:104-165, 216-272): the input bin n_in is the first e_ref
    at or above e, the output bin the first n_out whose P_ref[n_out, n_in]
    reaches u_cdf, the energy a linear draw u_e inside that bin, and the
    weight w * w_abs[n_out, n_in] * e_new / e. Returns (e_new, w_new)."""
    n_ref = e_ref.shape[0]
    n_in = torch.clamp(torch.searchsorted(
        e_ref, e.to(e_ref.dtype).contiguous(), side="left"), 0, n_ref - 1)
    rows = p_ref_t[n_in]                                 # (k, n_ref)
    n_out = torch.clamp(torch.searchsorted(
        rows, u_cdf.to(rows.dtype)[:, None].contiguous(),
        side="left")[:, 0], 0, n_ref - 1)
    e_lo = e_ref[torch.clamp_min(n_out - 1, 0)]
    e_hi = e_ref[n_out]
    e_new = torch.where(n_out > 0, e_lo + u_e * (e_hi - e_lo),
                        e_ref[0]).to(torch.float32)
    w_new = w * w_abs_t[n_in, n_out].to(torch.float32) * e_new \
        / torch.clamp_min(e, 1e-30)
    return e_new, w_new


# draw(first_stream, n_streams, idx) -> uniforms of n_streams scatters for
# each slot in idx, stream-major: stream 0 is the parent's draw, 1 + m the
# draw of tail copy m (the reference's k_scat and fold_in(k_scat, 1 + m));
# the weighted sampler's uniforms under strat_split, else the rejection
# sampler's (stream 0 only)
ScatterDrawFn = Callable[[int, int, torch.Tensor], ScatterDraws]


def generator_draws(seed: int, max_tries: int) -> ScatterDrawFn:
    """The stratified scatter draw layer of one round: the parent stream
    and the copy streams come from two generators seeded from ``seed``, so
    the parents' numbers do not depend on the number of copies."""

    def draw(first_stream: int, n_streams: int, idx: torch.Tensor):
        gen = torch.Generator(device=idx.device)
        gen.manual_seed((seed + min(first_stream, 1)) % (1 << 63))
        return draw_scatter_uniforms(gen, n_streams * idx.shape[0],
                                     max_tries, idx.device)

    return draw


def round_seed(gen: torch.Generator, device) -> int:
    """A round's scatter stream seed (the reference's k_scat), from
    ``gen``: one host read."""
    return tm.read("track.seed", torch.randint(
        0, 1 << 62, (1,), generator=gen, device=device), int)


class LoopDraws(NamedTuple):
    """The uniforms of one iteration of the lock-step loop, in the order
    of the reference's streams (fold_in(key, it) split into k_tau,
    k_absp, k_scat, k_refl1, k_refl2). The leak and scatter uniforms are
    asked for only when a lane leaks (with cr_sent != 0) or scatters."""

    u_tau: torch.Tensor              # (n,) optical depth draw, [1e-12, 1)
    u_abs: torch.Tensor              # (n,) absorption depth draw, [1e-7, 1)
    leak: Callable[[], LeakDraws]
    scatter: ScatterDrawFn


def generator_loop_draws(gen: torch.Generator, n: int, device,
                         st: TrackStatics) -> LoopDraws:
    """One iteration's uniforms from ``gen``: u_tau and u_abs mapped to
    their ranges as ``jax.random.uniform(minval, maxval)`` maps them; the
    rejection sampler's uniforms straight from ``gen``, the stratified
    sampler's from a seed read from it (``generator_draws``)."""
    u = torch.rand((2, n), generator=gen, device=device)
    t = int(st.max_scatter_tries)
    strat = []     # the iteration's stratified draw layer, made once

    def strat_draw(first_stream, n_streams, idx):
        if not strat:
            strat.append(generator_draws(round_seed(gen, device), t))
        return strat[0](first_stream, n_streams, idx)

    def rejection_draw(first_stream, n_streams, idx):
        return draw_scatter_uniforms(gen, n_streams * idx.shape[0], t,
                                     device, rejection=True)

    return LoopDraws(
        u_tau=torch.clamp_min(u[0] * (1.0 - 1e-12) + 1e-12, 1e-12),
        u_abs=torch.clamp_min(u[1] * (1.0 - 1e-7) + 1e-7, 1e-7),
        leak=lambda: draw_leak_uniforms(gen, n, device),
        scatter=strat_draw if st.strat_split else rejection_draw,
    )


def segment_sum(vals: torch.Tensor, idx: torch.Tensor,
                n_seg: int) -> torch.Tensor:
    """Deterministic sum of ``vals`` (n,) or (n, k) into ``n_seg``
    segments by ``idx`` (all in [0, n_seg)). A stable sort groups each
    segment's values in slot order and ``segment_reduce`` adds every
    segment in a fixed order, so equal inputs give bitwise-equal sums
    (no float atomics)."""
    idx = idx.long()
    order = torch.argsort(idx, stable=True)
    # bincount reads its smallest and largest index back to size its result
    lengths = tm.read("segment.lengths", idx, functools.partial(
        torch.bincount, minlength=n_seg))
    return torch.segment_reduce(vals[order], "sum", lengths=lengths,
                                axis=0, unsafe=True, initial=0.0)


def hist2d(vals, zid, nzr: int, bins, n_bins: int) -> torch.Tensor:
    """(nzr, n_bins) sums of vals by (zid, bins), deterministic."""
    flat = zid.long() * n_bins + bins.long()
    return segment_sum(vals, flat, nzr * n_bins).reshape(nzr, n_bins)


def loggrid_bin(e, log0, dlog, n_bins: int):
    """Bin on the log grid starting at exp(log0) with ratio exp(dlog);
    photons below one ratio under the first point are out of range."""
    x = (torch.log(torch.clamp_min(e, 1e-30)) - log0) / dlog
    b = torch.clamp(torch.floor(x).to(torch.int32), 0, n_bins - 1)
    return b, x > -1.0


def spectral_bin(hu, e):
    """Spectrum bin index, -1 outside [hu_0, hu_N] (imcleak2d.f:342-371)."""
    i = torch.searchsorted(hu, e.to(hu.dtype).contiguous()).to(torch.int32) - 1
    valid = (e > hu[0] * 1.000001) & (e < hu[-1] * 0.999999)
    return torch.where(valid, torch.clamp(i, 0, hu.shape[0] - 2), -1).to(
        torch.int32
    )


def lc_bin(lc_lo, lc_hi, e):
    """First light-curve band containing e, -1 if none
    (imcleak2d.f:375-386)."""
    e_c = e.to(lc_lo.dtype)
    m = (e_c[:, None] > lc_lo[None, :]) & (e_c[:, None] <= lc_hi[None, :])
    first = torch.argmax(m.to(torch.int32), dim=1).to(torch.int32)
    return torch.where(torch.any(m, dim=1), first, -1).to(torch.int32)


def mu_bin(mu_edges, mu):
    """Angular bin: first n with mu <= mu_edges[n] (imcleak2d.f:390-398)."""
    i = torch.searchsorted(mu_edges, mu.to(mu_edges.dtype).contiguous())
    return torch.clamp(i, 0, mu_edges.shape[0] - 1).to(torch.int32)


def loggrid_interp(table: torch.Tensor, zid: torch.Tensor, e: torch.Tensor,
                   log0, dlog) -> torch.Tensor:
    """Log-linear interpolation of per-zone tables ``table`` (nzones, n_e)
    or (nzones, n_e, k) at photon energies ``e`` in zones ``zid``."""
    n_e = table.shape[1]
    x = (torch.log(torch.clamp_min(e, 1e-30)) - log0) / dlog
    x = torch.clamp(x, 0.0, n_e - 1.000001)
    i0 = torch.floor(x).long()
    f = (x - i0).to(table.dtype)
    z = zid.long()
    v0 = table[z, i0]
    v1 = table[z, i0 + 1]
    if table.dim() == 3:
        f = f[:, None]
    return v0 * (1.0 - f) + v1 * f


def draw_seeds(gen: torch.Generator, n_tiles: int, device) -> torch.Tensor:
    """Per-tile int32 kernel seeds (uniform over all 2^32 bit patterns)."""
    s = torch.randint(0, 1 << 32, (n_tiles,), generator=gen, device=device,
                      dtype=torch.int64)
    return torch.where(s >= (1 << 31), s - (1 << 32), s).to(torch.int32)


def transport_step(
    photons: PhotonArray, tallies: Tallies, events: EventBuffer,
    gen: torch.Generator, ctx: TrackContext, st: TrackStatics,
) -> Tuple[PhotonArray, Tallies, EventBuffer]:
    """Track every photon to census, escape or absorption with the
    tracker ``st.tracker``; photons still in flight at the iteration
    budget (stragglers, counted in ``n_straggler``) go to census as they
    are, and ``trk_rounds`` counts the kernel's rounds or the loop's
    iterations."""
    if st.tracker == "loop":
        ph, tl, ev, rounds = _track_loop(photons, tallies, events, gen,
                                         ctx, st)
    elif st.tracker == "kernel":
        ph, tl, ev, rounds = _track_kernel(photons, tallies, events, gen,
                                           ctx, st)
    else:
        raise ValueError(f"tracker {st.tracker!r} is not 'kernel' or 'loop'")
    tl = tl._replace(
        trk_rounds=tl.trk_rounds + rounds,
        n_straggler=tl.n_straggler + torch.sum(ph.alive & (ph.dcen > 0.0),
                                               dtype=torch.int32),
    )
    ph = ph._replace(dcen=torch.where(ph.alive, 0.0, ph.dcen))
    return ph, tl, ev


def _track_kernel(photons, tallies, events, gen, ctx, st):
    """Outer rounds of the flight kernel with the leaks (and, under
    stratified splitting, the scatters) handled between rounds. The rounds
    stop once the accumulated kernel iterations reach max_iters, so flight
    iterations are bounded by 2*max_iters. Grids above flight.MAX_ZONES
    run the kernel's windowed mode: a lane frozen with FLAG_WINDOW keeps
    its state and flies on in the next round, under its tile's new
    window. Returns the state and the rounds."""
    n = photons.n_slots
    num_nt = ctx.cdf_nt.shape[1]
    inline = not st.strat_split
    with tm.span("track.tables"):
        ftab = flight.build_flight_tables(
            ctx.opac_zone, ctx.cdf_nt, ctx.gnt, ctx.r_edges, ctx.z_edges,
            ctx.e_ph_log0, ctx.e_ph_dlog, kgg_zone=ctx.kgg_zone,
            e_gg_log0=ctx.e_gg_host[0], e_gg_dlog=ctx.e_gg_host[1],
            u_edges=ctx.guide_u)
    ph, tl, ev = photons, tallies, events
    rnd, it_tot = 0, 0
    while (rnd < st.max_iters and it_tot < st.max_iters
           and tm.read("track.more", torch.any(ph.alive & (ph.dcen > 0.0)),
                       bool)):
        seeds = draw_seeds(gen, n // flight.TILE, ph.e.device)
        with tm.span("track.flight"):
            res = flight.flight_step(
                ph.e, ph.w, ph.w0, ph.r, ph.z, ph.mu, ph.cphi, ph.sphi,
                ph.dcen, ph.jz, ph.kr, ph.alive, ftab, seeds,
                nz=st.nz, nr=st.nr, weight_floor=float(st.weight_floor),
                max_iters=int(st.max_iters),
                max_tries=int(st.max_scatter_tries), inline_scatter=inline,
                pair_switch=bool(st.pair_switch),
            )
        ph = ph._replace(
            e=res.e, w=res.w, r=res.r, z=res.z, mu=res.mu, cphi=res.cphi,
            sphi=res.sphi, dcen=res.dcen, jz=res.jz, kr=res.kr,
            alive=res.alive,
        )
        tl = tl._replace(
            edep=tl.edep + res.tally[0].reshape(st.nz, st.nr),
            prdep=tl.prdep + res.tally[1].reshape(st.nz, st.nr),
            e_killed=tl.e_killed + res.ekill,
            e_scatter=tl.e_scatter + res.esct,
            e_pair_abs=tl.e_pair_abs + res.epair,
            n_window=tl.n_window + torch.sum(res.flag == flight.FLAG_WINDOW,
                                             dtype=torch.int32),
        )
        if inline:
            # e_ic / n_esp from the per-lane event logs; events past K_LOG
            # keep their energy in edep / e_scatter and are counted here
            logged = res.iglog.reshape(-1) >= 0
            ig = torch.where(logged, res.iglog.reshape(-1), 0)
            de = torch.where(logged, res.delog.reshape(-1), 0.0)
            tl = tl._replace(
                n_sct_overflow=tl.n_sct_overflow + torch.sum(
                    torch.clamp_min(res.sct_cnt - flight.K_LOG, 0),
                    dtype=torch.int32,
                ),
                e_ic=tl.e_ic + segment_sum(de, ig, num_nt),
                n_esp=tl.n_esp + segment_sum(logged.to(torch.float32), ig,
                                             num_nt),
            )
        else:
            # the round's scatter stream (the reference's k_scat)
            scat_seed = round_seed(gen, ph.e.device)
        leak_mask = (res.flag == flight.FLAG_LEAK) & ph.alive
        if tm.read("track.leak", torch.any(leak_mask), bool):
            with tm.span("track.leak"):
                draws = (draw_leak_uniforms(gen, n, ph.e.device)
                         if st.cr_sent else None)
                ph, tl, ev = _leak(ph, tl, ev, leak_mask, res.jn, res.kn,
                                   ctx, st, draws)
        if not inline:
            sct = (res.flag == flight.FLAG_SCATTER) & ph.alive
            if tm.read("track.scatter", torch.any(sct), bool):
                with tm.span("track.scatter"):
                    zid = (torch.clamp(ph.jz, 0, st.nz - 1) * st.nr
                           + torch.clamp(ph.kr, 0, st.nr - 1))
                    ph, tl = apply_scatter(
                        ph, tl, sct, zid, generator_draws(
                            scat_seed, int(st.max_scatter_tries)), ctx, st)
        rnd += 1
        it_tot += res.it_used
    tm.count("track.rounds", rnd)
    return ph, tl, ev, rnd


def _track_loop(photons, tallies, events, gen, ctx, st):
    """The lock-step loop (``tracking._flight_phase``, tracking.py:294-489
    of the reference): iterations over every slot while a live slot has
    census distance left, at most st.max_iters of them. Each asks the
    device three questions (the loop condition, any leak, any scatter).
    Returns the state and the iterations."""
    ph, tl, ev = photons, tallies, events
    n, dev = ph.n_slots, ph.e.device
    it = 0
    while (it < st.max_iters
           and tm.read("loop.more", torch.any(ph.alive & (ph.dcen > 0.0)),
                       bool)):
        ph, tl, ev = loop_iteration(ph, tl, ev, ctx, st,
                                    generator_loop_draws(gen, n, dev, st))
        it += 1
    tm.count("loop.iterations", it)
    return ph, tl, ev, it


def loop_iteration(ph: PhotonArray, tl: Tallies, ev: EventBuffer,
                   ctx: TrackContext, st: TrackStatics, draws: LoopDraws
                   ) -> Tuple[PhotonArray, Tallies, EventBuffer]:
    """One flight leg of every live slot with census distance left (the
    body of the reference's ``_flight_phase``, imctrk2d.f:170-684): the
    sigma / kappa lookup, the optical depth draw, the distance to the zone
    boundary, the nearest event (census, collision or boundary), the
    continuous absorption (with the gamma-gamma share under pair_switch)
    and its pressure deposit, the weight-floor kill, the move (pinned to
    the boundary point on a crossing), the zone hop or the leak, and the
    Compton scatter."""
    where = torch.where
    f32 = torch.float32
    nz, nr = st.nz, st.nr
    act = ph.alive & (ph.dcen > 0.0)
    jz_c = torch.clamp(ph.jz, 0, nz - 1)
    kr_c = torch.clamp(ph.kr, 0, nr - 1)
    zid = jz_c * nr + kr_c

    # ---- cross sections and the optical depth draw ----------------------
    sk = loggrid_interp(ctx.opac_zone, zid, ph.e, ctx.e_ph_log0,
                        ctx.e_ph_dlog)
    sig_s = torch.clamp_min(sk[:, 0], 1e-30)
    kap = sk[:, 1]
    dcol = -torch.log(draws.u_tau) / sig_s

    # ---- geometry and the event (imctrk2d.f:216-379) --------------------
    g = geometry.distance_to_boundary(ph.r, ph.z, ph.mu, ph.cphi, ph.sphi,
                                      jz_c, kr_c, ctx.r_edges, ctx.z_edges)
    trld = torch.minimum(ph.dcen, dcol)
    ikind = where(ph.dcen <= dcol, 2, 3)
    hit_bnd = g.trldb < trld
    trld = where(hit_bnd, g.trldb, trld)
    ikind = where(hit_bnd, 1, ikind)

    # ---- continuous absorption (imctrk2d.f:382-462) ---------------------
    if st.pair_switch:
        kgg = loggrid_interp(ctx.kgg_zone, zid, ph.e, ctx.e_gg_log0,
                             ctx.e_gg_dlog)
        e_gg0 = torch.exp(ctx.e_gg_log0.to(f32))
        kgg = where(ph.e > e_gg0, kgg, kgg * ph.e / e_gg0)
        sigabs = torch.clamp_min(kap + kgg, 1e-30)
    else:
        sigabs = torch.clamp_min(kap, 1e-30)
    xabs = sigabs * trld
    ewnew = where(xabs < 100.0, ph.w * torch.exp(-xabs), 0.0)
    deleabs = torch.clamp_min(ph.w - ewnew, 0.0)
    if st.pair_switch:
        # above 47 keV the gamma-gamma share becomes pairs, not heat
        frac_heat = where(ph.e > 47.0, kap / sigabs, 1.0)
        tl = tl._replace(e_pair_abs=tl.e_pair_abs + torch.sum(
            where(act, deleabs * (1.0 - frac_heat), 0.0)))
        edep_add = where(act, deleabs * frac_heat, 0.0)
    else:
        edep_add = where(act, deleabs, 0.0)
    # pressure deposit at a sampled absorption depth (imctrk2d.f:440-457)
    tiny_abs = xabs <= 1e-5
    frac = torch.clamp(-torch.expm1(-xabs) * draws.u_abs, 0.0, 0.999999)
    sstar = where(tiny_abs, 0.5 * trld, -torch.log1p(-frac) / sigabs)
    denom = torch.sqrt(torch.clamp_min(
        ph.r ** 2 + 2.0 * ph.mu * ph.r * sstar + sstar ** 2, 1e-20))
    wmustar = where(tiny_abs, ph.mu, (ph.mu * ph.r + sstar) / denom)
    prdep_add = where(act, deleabs * wmustar * float(np.float32(C_LIGHT)),
                      0.0)
    dep = segment_sum(torch.stack([edep_add, prdep_add], dim=1), zid,
                      nz * nr)
    killed = act & (ewnew <= st.weight_floor * ph.w0)
    tl = tl._replace(
        edep=tl.edep + dep[:, 0].reshape(nz, nr),
        prdep=tl.prdep + dep[:, 1].reshape(nz, nr),
        e_killed=tl.e_killed + torch.sum(where(killed, ewnew, 0.0)),
    )

    # ---- move, pinned to the boundary point on a crossing ---------------
    on_bnd = act & (ikind == 1)
    f_h = trld * torch.sqrt(torch.clamp_min(1.0 - ph.mu ** 2, 0.0))
    r_free = torch.sqrt(torch.clamp_min(
        f_h ** 2 + ph.r ** 2 + 2.0 * f_h * ph.r * ph.cphi, 0.0))
    rnew = where(on_bnd, g.rbnd, r_free)
    znew = where(on_bnd, g.zbnd, ph.z + trld * ph.mu)
    rs = torch.clamp_min(rnew, 1e-20)
    cphi_n = torch.clamp((f_h + ph.cphi * ph.r) / rs, -1.0, 1.0)
    sphi_n = torch.clamp(ph.sphi * ph.r / rs, -1.0, 1.0)
    nrm = torch.sqrt(torch.clamp_min(cphi_n ** 2 + sphi_n ** 2, 1e-12))
    upd = act & ~killed
    ph = ph._replace(
        w=where(act, where(killed, 0.0, ewnew), ph.w),
        r=where(upd, rnew, ph.r),
        z=where(upd, znew, ph.z),
        cphi=where(upd, cphi_n / nrm, ph.cphi),
        sphi=where(upd, sphi_n / nrm, ph.sphi),
        dcen=where(upd, ph.dcen - trld, ph.dcen),
        alive=ph.alive & ~killed,
    )

    # ---- zone hops and leaks --------------------------------------------
    cross = upd & (ikind == 1)
    in_dom = (g.jnew >= 0) & (g.jnew < nz) & (g.knew >= 0) & (g.knew < nr)
    hop = cross & in_dom
    ph = ph._replace(jz=where(hop, g.jnew, ph.jz),
                     kr=where(hop, g.knew, ph.kr))
    leak = cross & ~in_dom
    if tm.read("loop.leak", torch.any(leak), bool):
        ph, tl, ev = _leak(ph, tl, ev, leak, g.jnew, g.knew, ctx, st,
                           draws.leak() if st.cr_sent else None)

    # ---- Compton scatter (imctrk2d.f:580-684) ---------------------------
    sct = upd & (ikind == 3) & ph.alive
    if tm.read("loop.scatter", torch.any(sct), bool):
        ph, tl = apply_scatter(ph, tl, sct, zid, draws.scatter, ctx, st)
    return ph, tl, ev


def apply_scatter(ph: PhotonArray, tl: Tallies, sct: torch.Tensor,
                  zid: torch.Tensor, draw: ScatterDrawFn, ctx: TrackContext,
                  st: TrackStatics) -> Tuple[PhotonArray, Tallies]:
    """Execute the Compton scatters of the lanes ``sct`` in zones ``zid``
    (the ikind=3 branch, imctrk2d.f:580-684). Without strat_split each
    lane scatters once by the rejection sampler (``scatter.scatter``, its
    uniforms from ``draw(0, 1, idx)``). With stratified tail splitting the
    parent samples the electron stratum below the tail boundary c =
    cdf[strat_icut] with weight 1 - p_tail; M = strat_copies copies in
    free slots each sample an equal sub-stratum of the tail [c, 1) with
    weight p_tail / M. Placement is all-or-nothing per scatter, in slot
    order, while free slots last, so the strata stay exactly unbiased.
    Only the scattering lanes are computed (one host read of their
    count)."""
    if not st.strat_split:
        return _apply_rejection_scatter(ph, tl, sct, zid, draw, ctx, st)
    nzr = st.nz * st.nr
    num_nt = ctx.cdf_nt.shape[1]
    m_cp = max(int(st.strat_copies), 1)
    # scattering slots
    idx = tm.read("scatter.lanes", sct, torch.nonzero).reshape(-1)
    z = zid[idx].long()
    e_pre, mu_pre = ph.e[idx], ph.mu[idx]
    cphi_pre, sphi_pre = ph.cphi[idx], ph.sphi[idx]
    w_par = ph.w[idx]
    cdf_rows = ctx.cdf_nt[z]                       # (k, num_nt)
    c = cdf_rows[:, st.strat_icut]
    p_tail = torch.clamp(1.0 - c, 0.0, 1.0)
    want = (p_tail > st.strat_p_min) & (p_tail <= st.strat_p_max)
    free_slots = tm.read("scatter.lanes", ~ph.alive,
                         torch.nonzero).reshape(-1)   # slot of free rank
    rank = torch.cumsum(want.to(torch.int32), dim=0) - 1
    placed = want & ((rank + 1) * m_cp <= free_slots.shape[0])

    # 1/Z with Z = <sigma_KN ratio> = sig_s / (n_eff sigma_T L)
    sig_s = torch.clamp_min(loggrid_interp(
        ctx.opac_zone[:, :, 0], z, e_pre, ctx.e_ph_log0, ctx.e_ph_dlog),
        1e-30)
    inv_z = 1.0 / torch.clamp_min(sig_s * ctx.inv_nsigt[z], 1e-30)
    need = torch.ones_like(want)
    res_p = scatter_stratified(
        e_pre, mu_pre, cphi_pre, sphi_pre, cdf_rows, ctx.gnt,
        torch.zeros_like(c), torch.where(placed, c, 1.0), inv_z,
        draw(0, 1, idx), need)
    w_pre_p = torch.where(placed, w_par * (1.0 - p_tail), w_par)
    w_new_p = w_pre_p * res_p.wscale
    d_e = [w_new_p - w_pre_p]
    d_zone, d_gam = [z], [res_p.i_gam]
    ph = ph._replace(
        e=ph.e.index_copy(0, idx, res_p.e),
        w=ph.w.index_copy(0, idx, w_new_p),
        mu=ph.mu.index_copy(0, idx, res_p.mu),
        cphi=ph.cphi.index_copy(0, idx, res_p.cphi),
        sphi=ph.sphi.index_copy(0, idx, res_p.sphi),
    )

    pl = tm.read("scatter.lanes", placed,
                 torch.nonzero).reshape(-1)     # ranks 0..n_placed-1
    n_pl = pl.shape[0]
    if n_pl:
        # copy m of the parent of rank j goes to the free slot of rank
        # j * M + m; copies are laid out (M, n_placed), copy-major
        slots = free_slots[:n_pl * m_cp].reshape(n_pl, m_cp).t().reshape(-1)
        m_lo, m_hi = ctx.strat_frac
        cp = c[pl][None, :]
        u_lo = (cp + (1.0 - cp) * m_lo).reshape(-1)
        last = torch.arange(m_cp, device=c.device)[:, None] == m_cp - 1
        u_hi = torch.where(last, 1.0, cp + (1.0 - cp) * m_hi).reshape(-1)

        def rep(x):
            return x[pl].repeat(m_cp)

        res_c = scatter_stratified(
            rep(e_pre), rep(mu_pre), rep(cphi_pre), rep(sphi_pre),
            cdf_rows[pl].repeat(m_cp, 1), ctx.gnt, u_lo, u_hi, rep(inv_z),
            draw(1, m_cp, idx[pl]), torch.ones_like(u_lo, dtype=torch.bool))
        w_pre_c = rep(w_par * p_tail * float(np.float32(1.0 / m_cp)))
        w_new_c = w_pre_c * res_c.wscale
        d_e.append(w_new_c - w_pre_c)
        d_zone.append(rep(z))
        d_gam.append(res_c.i_gam)
        par = idx[pl].repeat(m_cp)
        ph = ph._replace(
            e=ph.e.index_copy(0, slots, res_c.e),
            w=ph.w.index_copy(0, slots, w_new_c),
            w0=ph.w0.index_copy(0, slots, torch.clamp_min(w_new_c, 1e-30)),
            r=ph.r.index_copy(0, slots, ph.r[par]),
            z=ph.z.index_copy(0, slots, ph.z[par]),
            mu=ph.mu.index_copy(0, slots, res_c.mu),
            cphi=ph.cphi.index_copy(0, slots, res_c.cphi),
            sphi=ph.sphi.index_copy(0, slots, res_c.sphi),
            dcen=ph.dcen.index_copy(0, slots, ph.dcen[par]),
            jz=ph.jz.index_copy(0, slots, ph.jz[par]),
            kr=ph.kr.index_copy(0, slots, ph.kr[par]),
            alive=ph.alive.index_fill(0, slots, True),
        )

    d_e, d_zone, d_gam = torch.cat(d_e), torch.cat(d_zone), torch.cat(d_gam)
    tl = tl._replace(
        edep=tl.edep + segment_sum(d_e, d_zone, nzr).reshape(st.nz, st.nr),
        e_ic=tl.e_ic + segment_sum(d_e, d_gam, num_nt),
        n_esp=tl.n_esp + segment_sum(torch.ones_like(d_e), d_gam, num_nt),
        e_scatter=tl.e_scatter + torch.sum(d_e),
    )
    return ph, tl


def _apply_rejection_scatter(ph, tl, sct, zid, draw, ctx, st):
    """The branch of :func:`apply_scatter` without strat_split
    (tracking.py:813-839 of the reference): each lane in ``sct`` scatters
    off its zone's electrons by rejection; its weight scales by E'/E, and
    the energy it gains is added to edep and e_scatter (the audit's
    absorbed energy is edep - e_scatter) and, by electron bin, to e_ic
    and n_esp."""
    nzr = st.nz * st.nr
    num_nt = ctx.cdf_nt.shape[1]
    idx = tm.read("scatter.lanes", sct, torch.nonzero).reshape(-1)
    z = zid[idx].long()
    w_old = ph.w[idx]
    res = scatter(ph.e[idx], ph.mu[idx], ph.cphi[idx], ph.sphi[idx],
                  ctx.cdf_nt[z], ctx.gnt, draw(0, 1, idx),
                  torch.ones_like(idx, dtype=torch.bool))
    w_new = w_old * res.wscale
    d_e = w_new - w_old
    tl = tl._replace(
        edep=tl.edep + segment_sum(d_e, z, nzr).reshape(st.nz, st.nr),
        e_ic=tl.e_ic + segment_sum(d_e, res.i_gam, num_nt),
        n_esp=tl.n_esp + segment_sum(torch.ones_like(d_e), res.i_gam,
                                     num_nt),
        e_scatter=tl.e_scatter + torch.sum(d_e),
    )
    ph = ph._replace(
        e=ph.e.index_copy(0, idx, res.e),
        w=ph.w.index_copy(0, idx, w_new),
        mu=ph.mu.index_copy(0, idx, res.mu),
        cphi=ph.cphi.index_copy(0, idx, res.cphi),
        sphi=ph.sphi.index_copy(0, idx, res.sphi),
    )
    return ph, tl


def _leak(ph: PhotonArray, tl: Tallies, ev: EventBuffer, mask, jnew, knew,
          ctx: TrackContext, st: TrackStatics,
          draws: Optional[LeakDraws] = None):
    """Boundary handler (imcleak2d.f): escapes through the outer, upper and
    lower boundaries, the inner boundary (absorbing when r_min > 0, a
    transparent axis otherwise), Compton reflection (cr_sent 1-4, with the
    uniforms ``draws``) and the event records.

    A lane reflected at the lower boundary (cr_sent 1/3/4) is sampled off
    the reflection tables where the ring's boundary is thermal, else
    mirrored (and always mirrored under cr_sent 4); it turns upward into
    zone row 0 and stays alive. A downward photon leaving the outer radius
    (cr_sent 2/3) is reflected off the disk, recorded with its flight time
    to the z = 0 plane and killed."""
    n = ph.n_slots
    where = torch.where
    i32 = torch.int32
    at_inner = mask & (knew < 0)
    at_outer = mask & (knew >= st.nr)
    at_lower = mask & (jnew < 0) & ~at_inner & ~at_outer
    at_upper = mask & (jnew >= st.nz) & ~at_inner & ~at_outer
    jz_c = torch.clamp(ph.jz, 0, st.nz - 1)
    kr_c = torch.clamp(ph.kr, 0, st.nr - 1)
    tbbl_pos = ctx.tbbl_pos[kr_c.long()]

    if st.rmin_positive:
        tl = tl._replace(erlk_inner=tl.erlk_inner + segment_sum(
            where(at_inner, ph.w, 0.0), jz_c, st.nz))
        die_inner = at_inner
    else:
        # transparent axis: point outward, stay in zone 0
        ph = ph._replace(
            cphi=where(at_inner, 1.0, ph.cphi),
            sphi=where(at_inner, 1e-6, ph.sphi),
            kr=where(at_inner, 0, ph.kr),
        )
        die_inner = torch.zeros(n, dtype=torch.bool, device=mask.device)
    tl = tl._replace(
        erlk_outer=tl.erlk_outer + segment_sum(
            where(at_outer, ph.w, 0.0), jz_c, st.nz),
        erlk_upper=tl.erlk_upper + segment_sum(
            where(at_upper, ph.w, 0.0), kr_c, st.nr),
        erlk_lower=tl.erlk_lower + segment_sum(
            where(at_lower, ph.w, 0.0), kr_c, st.nr),
        ed_in=tl.ed_in + segment_sum(
            where(at_lower & tbbl_pos, ph.w, 0.0), kr_c, st.nr),
    )

    def reflect(sel, u_cdf, u_e):
        """Sample the reflection of the lanes ``sel`` only (one host read
        of their count): (slots, e_new, w_new)."""
        idx = tm.read("leak.lanes", sel, torch.nonzero).reshape(-1)
        e_new, w_new = sample_reflection(
            ph.e[idx], ph.w[idx], u_cdf[idx], u_e[idx], ctx.e_ref,
            ctx.p_ref_t, ctx.w_abs_t)
        return idx, e_new, w_new

    # ---- lower-boundary Compton reflection (imcleak2d.f:104-165) --------
    reflect_low = torch.zeros(n, dtype=torch.bool, device=mask.device)
    if st.cr_sent in (1, 3, 4):
        reflect_low = at_lower
        mirror = ~tbbl_pos | (st.cr_sent == 4)
        idx, e_new, w_new = reflect(reflect_low & ~mirror, draws.u_cdf_low,
                                    draws.u_e_low)
        tl = tl._replace(
            ed_ref=tl.ed_ref + segment_sum(w_new, kr_c[idx], st.nr),
            n_reflect_lower=tl.n_reflect_lower + torch.sum(
                reflect_low, dtype=i32),
        )
        ph = ph._replace(
            e=ph.e.index_copy(0, idx, e_new),
            w=ph.w.index_copy(0, idx, w_new),
            mu=where(reflect_low, torch.abs(ph.mu), ph.mu),
            jz=where(reflect_low, 0, ph.jz).to(i32),
        )

    # ---- outer-disk reflection (cr_sent 2/3, imcleak2d.f:216-272): a
    # downward photon leaving the outer radius reflects off the disk around
    # the corona, is recorded with its flight time to the disk plane and
    # killed ------------------------------------------------------------
    disk_extra_t = torch.zeros(n, dtype=torch.float32, device=mask.device)
    if st.cr_sent in (2, 3):
        disk_refl = at_outer & (ph.mu <= 0.0)
        idx, e_new, w_new = reflect(disk_refl, draws.u_cdf_disk,
                                    draws.u_e_disk)
        abs_mu = torch.clamp_min(torch.abs(ph.mu), 1e-6)
        mu_ok = torch.abs(ph.mu) > 1e-6
        # flight to the z = 0 disk plane (imcleak2d.f:247-255)
        extra_t = where(mu_ok, ph.z / abs_mu, 1e20)
        f_h = ph.z * torch.sqrt(torch.clamp_min(1.0 - ph.mu ** 2, 0.0)) \
            / abs_mu
        r_disk = torch.sqrt(torch.clamp_min(
            ph.r ** 2 + f_h ** 2 + 2.0 * ph.r * f_h * ph.cphi, 0.0))
        ph = ph._replace(
            e=ph.e.index_copy(0, idx, e_new),
            w=ph.w.index_copy(0, idx, w_new),
            z=where(disk_refl, 0.0, ph.z),
            r=where(disk_refl & mu_ok, r_disk, ph.r),
            mu=where(disk_refl, draws.u_mu, ph.mu),
        )
        disk_extra_t = where(disk_refl, extra_t, 0.0)
        tl = tl._replace(n_reflect_disk=tl.n_reflect_disk + torch.sum(
            disk_refl, dtype=i32))

    esc_lower = at_lower & ~reflect_low
    escaping = at_outer | esc_lower | at_upper | die_inner
    record = (at_outer | esc_lower | at_upper) & ~(
        at_upper & (ph.mu >= st.upper_escape_mu_cut)
    )
    f32 = torch.float32
    # remaining flight time plus the disk reflection's delay
    # (imcleak2d.f:203, 247-249)
    t_bound = (ctx.time.to(f32) + ctx.dt.to(f32)) - ctx.inv_c * (
        ph.dcen - disk_extra_t)

    sp = spectral_bin(ctx.hu, ph.e)
    lc = lc_bin(ctx.lc_lo, ctx.lc_hi, ph.e)
    mb = mu_bin(ctx.mu_edges, ph.mu)
    w_tal = where(record, ph.w, 0.0)
    if st.spec_switch == 1:
        # the spectra incident on the z boundaries (imcleak2d.f:116-117)
        w_sp = where(reflect_low | at_upper | at_lower, ph.w, 0.0)
    else:
        w_sp = w_tal
    nmu = tl.fout.shape[0]
    tl = tl._replace(
        fout=tl.fout + hist2d(
            where(sp >= 0, w_sp, 0.0), mb, nmu,
            torch.clamp_min(sp, 0), tl.fout.shape[1]),
        edout=tl.edout + hist2d(
            where(lc >= 0, w_tal, 0.0) / ctx.dt, mb, nmu,
            torch.clamp_min(lc, 0), tl.edout.shape[1]),
    )

    # event records (imcleak2d.f:105 format), in slot order
    phi = torch.atan2(ph.sphi, ph.cphi)
    rec = torch.stack([t_bound, ph.e, ph.w, ph.r, ph.z, ph.mu, phi], dim=1)
    rec_i = record.to(i32)
    cap = ev.data.shape[0]
    idx = ev.count + torch.cumsum(rec_i, dim=0, dtype=i32) - 1
    write = record & (idx < cap)
    # rows past capacity (and non-records) land in a scratch row
    data = torch.cat([ev.data, ev.data.new_zeros((1, 7))], dim=0)
    data[where(write, idx, cap).long()] = rec
    ev = ev._replace(
        data=data[:cap],
        count=ev.count + torch.sum(rec_i, dtype=i32),
    )
    ph = ph._replace(alive=ph.alive & ~(escaping | die_inner))
    return ph, tl, ev


def census_tally(photons: PhotonArray, tallies: Tallies, ctx: TrackContext,
                 st: TrackStatics) -> Tallies:
    """Census tallies over the surviving photons (imctrk2d.f:528-556):
    ecens/npcen per zone and the scaled radiation-field and gamma-gamma
    histograms n_field = sum(w / E) per (zone, bin)."""
    alive = photons.alive
    nzr = st.nz * st.nr
    zid = (torch.clamp(photons.jz, 0, st.nz - 1) * st.nr
           + torch.clamp(photons.kr, 0, st.nr - 1))
    w = torch.where(alive, photons.w, 0.0)
    cen2 = segment_sum(
        torch.stack([w, torch.where(alive, 1.0, 0.0).to(w.dtype)], dim=1),
        zid, nzr,
    )
    counts = torch.where(alive, w / torch.clamp_min(photons.e, 1e-30), 0.0)
    nphf = tallies.n_field.shape[-1]
    fbin, in_field = loggrid_bin(photons.e, ctx.e_field_log0,
                                 ctx.e_field_dlog, nphf)
    n_field = tallies.n_field.reshape(nzr, nphf) + hist2d(
        torch.where(in_field, counts, 0.0), zid, nzr, fbin, nphf)
    ngg = tallies.n_ph.shape[-1]
    gbin, in_gg = loggrid_bin(photons.e, ctx.e_gg_log0, ctx.e_gg_dlog, ngg)
    n_ph = tallies.n_ph.reshape(nzr, ngg) + hist2d(
        torch.where(in_gg, counts, 0.0), zid, nzr, gbin, ngg)
    return tallies._replace(
        ecens=(tallies.ecens.reshape(-1) + cen2[:, 0]).reshape(st.nz, st.nr),
        npcen=(tallies.npcen.reshape(-1) + cen2[:, 1]).reshape(st.nz, st.nr),
        n_field=n_field.reshape(st.nz, st.nr, nphf),
        n_ph=n_ph.reshape(st.nz, st.nr, ngg),
    )
