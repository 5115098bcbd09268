"""Compton scatter samplers (counterpart of
``compton2d_tpu.transport.scatter``; compb_2d.f:36-239).

Two samplers share the electron-frame stages (sz rejection, boost,
azimuth: ``_sample_sz`` and ``_finish_scatter``):

- :func:`scatter`, the rejection sampler of the lock-step flight loop
  (``tracking.loop_iteration``, outside stratified splitting): up to
  ``max_tries`` candidates of a target electron drawn by inverse CDF and an
  electron-photon angle from the relativistic flux factor, each accepted
  with probability sigma_KN(znue) / sigma_T;
- :func:`scatter_stratified`, the weighted sampler of stratified tail
  splitting: the electron by inverse CDF restricted to a stratum [u_lo,
  u_hi) of the zone's electron CDF, the angle from the flux measure, and
  the measure correction sigma_KN-ratio(znue) / Z carried in ``wscale``.

Random numbers come in as :class:`ScatterDraws`, so tests can feed the
reference's own uniforms. The reference's open-ended rejection loops
(retry until every lane accepts, at most ``max_tries`` rounds) become all
``max_tries`` candidates at once with the first accepted one kept: the
same value for every lane, and no host read of the loop condition.

A lane that accepts no electron candidate takes its last one with znue =
max(zn, 1e-10), the flight kernel's rule (flight_pallas2.py:722-740,
``transport/flight.py::flight_step_reference``). The reference's
``_sample_electron_and_angle`` keeps its loop's initial values there
(gamma 1, znue 1e-3: a 0.511 keV photon in the electron frame whatever
the photon's energy), which below about 1e-9 keV, where no candidate
reaches zn >= 1e-10, turns every scattered radio photon into a 0.51 keV
one of 5e9 times the weight (ROADMAP §C).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

EMASS_KEV = 511.0
_CLAMP = 0.9999999
_PI32 = float(np.float32(np.pi))


class ScatterResult(NamedTuple):
    e: torch.Tensor        # new photon energy [keV]
    mu: torch.Tensor       # new direction cosine
    cphi: torch.Tensor     # new azimuth unit vector
    sphi: torch.Tensor
    wscale: torch.Tensor   # multiplicative weight factor
    i_gam: torch.Tensor    # int32 electron bin index (e_ic / n_esp)


class ScatterDraws(NamedTuple):
    """The uniforms of one scatter for k lanes, following the reference's
    key splits. In the weighted sampler (``scatter_stratified``: k1a, k1b,
    k1c, k2, k3, k4, k5) ``u_e``, ``u_om`` and ``u_tl`` are (k,) and
    ``u_acc`` is None; in the rejection sampler (``scatter``) they and
    ``u_acc`` hold one row per electron candidate, (max_tries, k). The sz
    candidates are (max_tries, k) in both."""

    u_e: torch.Tensor      # electron CDF position (within the stratum)
    u_om: torch.Tensor     # electron-photon angle
    u_tl: torch.Tensor     # flux-factor flip
    u_sz1: torch.Tensor    # (max_tries, k) sz candidate
    u_sz2: torch.Tensor    # (max_tries, k) sz acceptance
    u_a1: torch.Tensor     # electron-frame azimuth
    u_a2: torch.Tensor     # lab azimuth
    u_sgn: torch.Tensor    # azimuth rotation sign
    u_acc: Optional[torch.Tensor] = None   # KN acceptance of a candidate


def draw_scatter_uniforms(gen: torch.Generator, k: int, max_tries: int,
                          device, rejection: bool = False) -> ScatterDraws:
    """All uniforms of k scatters in one call on ``gen``: for the weighted
    sampler, or with ``rejection`` for the rejection sampler."""
    t = max_tries
    if not rejection:
        u = torch.rand((2 * t + 6, k), generator=gen, device=device)
        return ScatterDraws(
            u_e=u[0], u_om=u[1], u_tl=u[2], u_sz1=u[3:3 + t],
            u_sz2=u[3 + t:3 + 2 * t], u_a1=u[3 + 2 * t], u_a2=u[4 + 2 * t],
            u_sgn=u[5 + 2 * t],
        )
    u = torch.rand((6 * t + 3, k), generator=gen, device=device)
    return ScatterDraws(
        u_e=u[:t], u_om=u[t:2 * t], u_tl=u[2 * t:3 * t],
        u_sz1=u[4 * t:5 * t], u_sz2=u[5 * t:6 * t], u_a1=u[6 * t],
        u_a2=u[6 * t + 1], u_sgn=u[6 * t + 2], u_acc=u[3 * t:4 * t],
    )


def _kn_ratio_f32(znue: torch.Tensor) -> torch.Tensor:
    """sigma_KN(z)/sigma_T (compb_2d.f:77-87) in f32: the 7-term series up
    to z = 0.15, the closed form above (the reference's reason: the
    closed form's numerator cancels to O(z^3) in f32)."""
    z = znue
    ser = 1.0 - z * (2.0 - z * (5.2 - z * (13.3 - z * (
        32.685714 - z * (77.714286 - z * 124.825397)
    ))))
    zs = torch.clamp_min(z, 1e-6)
    z3 = zs * zs * zs
    betz = 1.0 + 2.0 * zs
    gamz = zs * (zs - 2.0) - 2.0
    full = 0.375 * (
        4.0 * zs + 2.0 * z3 * (1.0 + zs) / (betz * betz)
        + gamz * torch.log(betz)
    ) / z3
    return torch.where(z <= 0.15, ser, full)


def _draw_from_cdf(u: torch.Tensor, cdf_rows: torch.Tensor,
                   gnt: torch.Tensor):
    """Inverse-CDF electron draw; ``cdf_rows`` (k, num_nt). The bin is the
    compare count #(cdf < u), which needs no monotone CDF; the bin-midpoint
    gamma - 1 is a gather (the reference's one-hot matmul)."""
    num_nt = gnt.shape[0]
    idx = torch.sum(cdf_rows < u[:, None], dim=-1, dtype=torch.int32)
    idx = torch.clamp(idx, 1, num_nt - 1)
    gm1_mid = torch.sqrt(gnt[1:] * gnt[:-1]).to(torch.float32)
    gamma = gm1_mid[(idx - 1).long()] + 1.0
    beta = torch.sqrt(torch.clamp_min(1.0 - 1.0 / (gamma * gamma), 0.0))
    return gamma, beta, idx


def _sample_sz(znue: torch.Tensor, u1: torch.Tensor, u2: torch.Tensor,
               need: torch.Tensor) -> torch.Tensor:
    """Stage 4 (compb_2d.f:98-107): sz = E'_rest / E_rest by rejection over
    the (max_tries, k) candidates; the first accepted candidate is kept, 1
    where none is or where ``need`` is false."""
    betz = 1.0 + 2.0 * znue
    phat = betz + 1.0 / betz
    s = (1.0 + 2.0 * znue * u1) / betz
    games = 1.0 + (1.0 - 1.0 / s) / znue
    ok_g = games * games <= 1.0
    tr = games * games - 1.0 + s + 1.0 / s
    ok = ok_g & (u2 * phat <= tr) & need
    first = torch.argmax(ok.to(torch.uint8), dim=0, keepdim=True)
    s_first = torch.gather(s, 0, first)[0]
    return torch.where(torch.any(ok, dim=0), s_first, 1.0)


def _finish_scatter(znu, mu, cphi, sphi, gamma, beta, omeg, znue, sz,
                    i_gam, u_a1, u_a2, u_sgn) -> ScatterResult:
    """Stages 5-6 (compb_2d.f:111-239): electron-frame angles, boost to
    the lab, new direction cosines and azimuth, weight scale E'/E."""
    znues = znue * sz
    cazes = torch.cos(_PI32 * (2.0 * u_a1 - 1.0))
    omege = torch.clamp((omeg - beta) / (1.0 - beta * omeg), -_CLAMP, _CLAMP)
    games = 1.0 + (1.0 - 1.0 / sz) / znue
    games = torch.clamp(games, -_CLAMP, _CLAMP)
    omeges = games * omege + cazes * torch.sqrt(torch.clamp_min(
        (1.0 - omege * omege) * (1.0 - games * games), 0.0))
    omeges = torch.clamp(omeges, -_CLAMP, _CLAMP)

    znus = (1.0 + beta * omeges) * gamma * znues
    gams = 1.0 - (znue - znues) / torch.clamp_min(znu * znus, 1e-30)
    gams = torch.clamp(gams, -_CLAMP, _CLAMP)

    cazs = torch.clamp(torch.cos(_PI32 * (2.0 * u_a2 - 1.0)),
                       -_CLAMP, _CLAMP)
    mu_c = torch.clamp(mu, -_CLAMP, _CLAMP)
    wmus = mu_c * gams + cazs * torch.sqrt(torch.clamp_min(
        (1.0 - gams * gams) * (1.0 - mu_c * mu_c), 0.0))
    wmus = torch.clamp(wmus, -_CLAMP, _CLAMP)

    cosd = (gams - mu_c * wmus) / torch.sqrt(torch.clamp_min(
        (1.0 - mu_c * mu_c) * (1.0 - wmus * wmus), 1e-20))
    cosd = torch.clamp(cosd, -_CLAMP, _CLAMP)
    sind = torch.sqrt(torch.clamp_min(1.0 - cosd * cosd, 0.0))
    sind = torch.where(u_sgn < 0.5, 1.0, -1.0).to(sind.dtype) * sind
    cphi_n = cphi * cosd - sphi * sind
    sphi_n = sphi * cosd + cphi * sind
    nrm = torch.sqrt(torch.clamp_min(cphi_n * cphi_n + sphi_n * sphi_n,
                                     1e-12))
    return ScatterResult(
        e=znus * EMASS_KEV, mu=wmus, cphi=cphi_n / nrm, sphi=sphi_n / nrm,
        wscale=znus / torch.clamp_min(znu, 1e-30), i_gam=i_gam,
    )


def _candidates(znu: torch.Tensor, cdf_rows: torch.Tensor, gnt: torch.Tensor,
                draws: ScatterDraws):
    """The (max_tries, k) electron candidates (gamma, beta, electron bin)
    and angles of the rejection sampler, and their electron-frame energy
    zn (compb_2d.f:36-74). The bin is ``_draw_from_cdf``'s compare count
    #(cdf < u), taken as the insertion point of u in the sorted row (which
    has the same count however the row is ordered), so the candidates need
    no (max_tries, k, num_nt) compare."""
    num_nt = gnt.shape[0]
    rows = torch.sort(cdf_rows, dim=-1).values
    idx = torch.searchsorted(rows, draws.u_e.t().contiguous()).t()
    idx = torch.clamp(idx, 1, num_nt - 1)
    gm1_mid = torch.sqrt(gnt[1:] * gnt[:-1]).to(torch.float32)
    gamma = gm1_mid[idx - 1] + 1.0
    beta = torch.sqrt(torch.clamp_min(1.0 - 1.0 / (gamma * gamma), 0.0))
    om = torch.clamp(2.0 * draws.u_om - 1.0, -_CLAMP, _CLAMP)
    # relativistic flux factor: flip with probability 1 - (1 - beta om)/2
    om = torch.clamp(torch.where(draws.u_tl > 0.5 * (1.0 - beta * om),
                                 -om, om), -_CLAMP, _CLAMP)
    zn = (1.0 - beta * om) * znu * gamma
    return gamma, beta, om, zn, idx.to(torch.int32)


def _sample_electron_and_angle(znu, cdf_rows, gnt, draws: ScatterDraws,
                               need: torch.Tensor):
    """Stages 1-3 (compb_2d.f:36-93): (gamma, beta, omeg, znue, i_gam) of
    the first candidate accepted with probability sigma_KN(zn) / sigma_T
    (and zn >= 1e-10); a lane that accepts none takes its last candidate
    with znue = max(zn, 1e-10), as the flight kernel does. Lanes outside
    ``need`` give values nobody reads."""
    gamma, beta, om, zn, idx = _candidates(znu, cdf_rows, gnt, draws)
    ok = (zn >= 1e-10) & (draws.u_acc <= _kn_ratio_f32(zn)) & need
    first = torch.argmax(ok.to(torch.uint8), dim=0)
    pick = torch.where(torch.any(ok, dim=0), first,
                       zn.shape[0] - 1)[None]

    def take(x):
        return torch.gather(x, 0, pick)[0]

    return (take(gamma), take(beta), take(om),
            torch.clamp_min(take(zn), 1e-10), take(idx))


def scatter(
    e_kev: torch.Tensor,      # (k,) photon energies
    mu: torch.Tensor,
    cphi: torch.Tensor,
    sphi: torch.Tensor,
    cdf_rows: torch.Tensor,   # (k, num_nt) each lane's zone electron CDF
    gnt: torch.Tensor,        # (num_nt,)
    draws: ScatterDraws,      # the rejection sampler's uniforms
    need: torch.Tensor,       # (k,) bool: lanes that scatter
) -> ScatterResult:
    """One Compton scatter of each lane by rejection (``scatter.scatter``
    of the reference, with the flight kernel's exhaustion rule):
    ``wscale`` = E'/E keeps the photon number."""
    znu = (e_kev / EMASS_KEV).to(torch.float32)
    gamma, beta, omeg, znue, i_gam = _sample_electron_and_angle(
        znu, cdf_rows, gnt, draws, need)
    sz = _sample_sz(znue, draws.u_sz1, draws.u_sz2, need)
    return _finish_scatter(znu, mu, cphi, sphi, gamma, beta, omeg, znue, sz,
                           i_gam, draws.u_a1, draws.u_a2, draws.u_sgn)


def scatter_stratified(
    e_kev: torch.Tensor,      # (k,) photon energies
    mu: torch.Tensor,
    cphi: torch.Tensor,
    sphi: torch.Tensor,
    cdf_rows: torch.Tensor,   # (k, num_nt) each lane's zone electron CDF
    gnt: torch.Tensor,        # (num_nt,)
    u_lo: torch.Tensor,       # (k,) electron-CDF stratum bounds
    u_hi: torch.Tensor,
    inv_z: torch.Tensor,      # (k,) 1/Z = n_eff sigma_T L / sigma_zone(E)
    draws: ScatterDraws,
    need: torch.Tensor,       # (k,) bool: lanes that scatter
) -> ScatterResult:
    """Weighted (rejection-free) scatter: gamma by inverse CDF within
    [u_lo, u_hi), the angle from the flux measure, and the KN measure
    correction sigma_KN-ratio(znue) * inv_z folded into ``wscale``.
    Unbiased for any stratum when the caller gives the stratum its
    probability u_hi - u_lo as weight fraction."""
    znu = (e_kev / EMASS_KEV).to(torch.float32)
    u_e = u_lo + draws.u_e * torch.clamp_min(u_hi - u_lo, 0.0)
    gamma, beta, i_gam = _draw_from_cdf(u_e, cdf_rows, gnt)
    om = torch.clamp(2.0 * draws.u_om - 1.0, -_CLAMP, _CLAMP)
    om = torch.clamp(torch.where(draws.u_tl > 0.5 * (1.0 - beta * om),
                                 -om, om), -_CLAMP, _CLAMP)
    znue = torch.clamp_min((1.0 - beta * om) * znu * gamma, 1e-10)
    w_kn = _kn_ratio_f32(znue) * inv_z
    sz = _sample_sz(znue, draws.u_sz1, draws.u_sz2, need)
    res = _finish_scatter(znu, mu, cphi, sphi, gamma, beta, om, znue, sz,
                          i_gam, draws.u_a1, draws.u_a2, draws.u_sgn)
    return res._replace(wscale=res.wscale * w_kn)
