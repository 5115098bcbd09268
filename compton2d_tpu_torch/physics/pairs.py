"""Gamma-gamma pair physics: opacity, pair production, annihilation
(counterpart of ``compton2d_tpu.physics.pairs``).

The host builders of the static kernels are copies of the reference's
float64 numpy code: the opacity matrix G(eps_out, eps_in) (``kgg_matrix``),
the pair-production tensor F(gamma, eps1, eps2) (``pairprod_tensor``) and
the annihilation table V(gamma_e, gamma_p) (``vsigma_matrix``). The
per-step functions run on tensors over the zone batch: two float32
contractions for dn_pp, two matmuls for the annihilation sinks, and the
Wien-tail fit of the noisy census field (``nph_smooth``), whose
4368-candidate grid search is one (zones, candidates) chi^2 tensor instead
of the reference's sequential loop.
"""
from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------------------
# gamma-gamma opacity (volume2d.f:401-441)
# ---------------------------------------------------------------------------
def _gg_mu_integral(s: np.ndarray) -> np.ndarray:
    """G(s) = int_{-1}^{mu_thr} (1-mu) f(beta) dmu with
    beta^2 = 1 - 2/(s (1-mu)), s = eps1*eps2; the reference evaluates
    this with a 100-point midpoint rule per pair (volume2d.f:419-432)."""
    s = np.asarray(s, np.float64)
    out = np.zeros_like(s)
    mask = s > 1.0
    sv = s[mask]
    mu_thr = np.minimum(1.0 - 2.0 / sv, 1.0)
    acc = np.zeros_like(sv)
    n_steps = 200
    for q in range(n_steps):
        frac = (q + 0.5) / n_steps
        dmu = (1.0 + mu_thr) / n_steps
        mu = -1.0 + frac * (mu_thr + 1.0)
        b2 = 1.0 - 2.0 / (sv * (1.0 - mu))
        ok = (b2 > 0.0) & (b2 < 1.0)
        beta = np.sqrt(np.maximum(b2, 1e-30))
        f = (1.0 - b2) * (
            (3.0 - b2 * b2)
            * np.log((1.0 + beta) / np.maximum(1.0 - beta, 1e-30))
            - 2.0 * beta * (2.0 - b2)
        )
        acc += np.where(ok, (1.0 - mu) * f * dmu, 0.0)
    out[mask] = acc
    return out


def kgg_matrix(e_gg: np.ndarray, length_scale: float = 1.0) -> np.ndarray:
    """Static matrix M[out, in] with
    kappa_gg(E_out) = sum_in n_ph_phys[in] * M[out, in]  [1/L].

    M = 6.234e-26 * G(eps_out*eps_in) * dE_in * L (volume2d.f:434-440).
    """
    e = np.asarray(e_gg, np.float64)
    eps = 1.957e-3 * e
    de = np.concatenate([np.diff(e), [0.0]])
    s = eps[:, None] * eps[None, :]
    G = _gg_mu_integral(s)
    return 6.234e-26 * float(length_scale) * G * de[None, :]


# ---------------------------------------------------------------------------
# pair production (pp2d.f:6-180)
# ---------------------------------------------------------------------------
def _i_pm(ecm, eps1, eps2, c):
    ee = eps1 * eps2
    with np.errstate(all="ignore"):
        d2p = ee + c * ecm**2
        pos = np.log(
            ecm * np.sqrt(np.maximum(c, 0.0))
            + np.sqrt(np.maximum(d2p, 1e-300))
        ) / np.sqrt(np.maximum(c, 1e-300))
        arg = np.clip(ecm * np.sqrt(np.maximum(-c, 0.0) / ee), -1.0, 1.0)
        neg = np.arcsin(arg) / np.sqrt(np.maximum(-c, 1e-300))
    return np.where(c > 1e-40, pos, np.where(c < -1e-40, neg, 0.0))


def _h_fn(ecm, eps1, eps2, gamma):
    ee = eps1 * eps2
    c = (eps1 - gamma) ** 2 - 1.0
    d = eps1**2 + ee + gamma * (eps2 - eps1)
    d2 = ee + c * ecm**2
    with np.errstate(all="ignore"):
        big = (
            -0.125 * ecm * (d / ee + 2.0 / c) / np.sqrt(np.maximum(d2, 1e-300))
            + 0.25 * (2.0 - (ee - 1.0) / c) * _i_pm(ecm, eps1, eps2, c)
            + 0.25 * np.sqrt(np.maximum(d2, 0.0))
            * (ecm / c + 1.0 / (ecm * ee))
        )
        small = (
            (ecm**3 / 12.0 - 0.125 * ecm * d) / ee**1.5
            + (ecm**3 / 6.0 + 0.5 * ecm + 0.25 / ecm) / np.sqrt(ee)
        )
    out = np.where(np.abs(c) > 1e-10, big, small)
    return np.where(d2 > 0.0, out, 0.0)


def _f_inner(ecm, eps1, eps2, gamma):
    E = eps1 + eps2
    f12 = E**2 - 4.0 * ecm**2
    f1 = 0.25 * np.sqrt(np.maximum(f12, 0.0))
    val = f1 + _h_fn(ecm, eps1, eps2, gamma) + _h_fn(ecm, eps2, eps1, gamma)
    return np.where(f12 >= 0.0, val, 0.0)


def f_pprod(eps1, eps2, gamma):
    """Differential pair-production kernel (pp2d.f:71-105)."""
    E = eps1 + eps2
    x = gamma * (E - gamma)
    det2 = (x + 1.0) ** 2 - E**2
    with np.errstate(all="ignore"):
        det = np.sqrt(np.maximum(det2, 0.0))
        estar2 = 0.5 * (x + 1.0 + det)
        edag2 = 0.5 * (x + 1.0 - det)
        estar = np.sqrt(np.maximum(estar2, 0.0))
        edag = np.sqrt(np.maximum(edag2, 0.0))
        ecm_u = np.minimum(np.sqrt(eps1 * eps2), estar)
        ecm_l = np.maximum(1.0, edag)
        val = _f_inner(ecm_u, eps1, eps2, gamma) - _f_inner(
            ecm_l, eps1, eps2, gamma
        )
    ok = (det2 >= 0.0) & (estar2 >= 0.0) & (edag2 >= 0.0) & (ecm_u > ecm_l)
    return np.where(ok, val, 0.0)


def pairprod_tensor(gnt: np.ndarray, e_gg: np.ndarray) -> np.ndarray:
    """Static F[gamma, p1, p2] = 1.496e-14 * f_pprod * dE1 dE2 /
    (eps1^2 eps2^2) so that
    dn_pp(z, gamma) = sum_{p1,p2} n1(z,p1) n2(z,p2) F[gamma,p1,p2]
    (pairprod, pp2d.f:24-48)."""
    gamma = np.asarray(gnt, np.float64) + 1.0
    e = np.asarray(e_gg, np.float64)
    eps = 1.957e-3 * e
    de = np.concatenate([np.diff(e), [0.0]])
    g = gamma[:, None, None]
    e1 = eps[None, :, None]
    e2 = eps[None, None, :]
    F = f_pprod(e1, e2, g)
    w1 = (de / eps**2)[None, :, None]
    w2 = (de / eps**2)[None, None, :]
    return 1.496e-14 * F * w1 * w2


def dn_pp_from_field(nph_phys: torch.Tensor,
                     pp_tensor: torch.Tensor) -> torch.Tensor:
    """dn_pp(z, gamma) from the (Z, n_gg) field [photons / cm^3 / keV]
    and the (num_nt, n_gg, n_gg) tensor: two float32 contractions (TF32
    off, as the reference's Precision.HIGHEST)."""
    t = torch.einsum("gpq,zq->zgp", pp_tensor, nph_phys)
    return torch.einsum("zgp,zp->zg", t, nph_phys)


# ---------------------------------------------------------------------------
# pair annihilation (pp2d.f:187-355)
# ---------------------------------------------------------------------------
def _f_vs(gcm):
    bcm = np.sqrt(np.maximum(1.0 - 1.0 / gcm**2, 1e-30))
    L = np.log((1.0 + bcm) / np.maximum(1.0 - bcm, 1e-30))
    return bcm**3 * gcm**2 * L - 2.0 * gcm**2 + 0.75 * L**2


def vsigma_matrix(gnt: np.ndarray) -> np.ndarray:
    """V[ge_idx, gp_idx] = <sigma v> for e+e- annihilation
    (vsigma, pp2d.f:310-340), static num_nt x num_nt table."""
    gamma = np.asarray(gnt, np.float64) + 1.0
    ge = gamma[:, None]
    gp = gamma[None, :]
    be = np.sqrt(np.maximum(1.0 - 1.0 / ge**2, 1e-20))
    bp = np.sqrt(np.maximum(1.0 - 1.0 / gp**2, 1e-20))
    gmin2 = 0.5 * (1.0 + ge * gp * (1.0 - be * bp))
    gmax2 = 0.5 * (1.0 + ge * gp * (1.0 + be * bp))
    gcm_min = np.where(gmin2 > 1.00002, np.sqrt(gmin2), 1.00001)
    gcm_max = np.where(gmax2 > 1.00002, np.sqrt(gmax2), 1.00001)
    v = 7.48e-15 * (_f_vs(gcm_max) - _f_vs(gcm_min)) / (
        be * bp * (ge * gp) ** 2
    )
    return np.where(gcm_max > gcm_min, v, 0.0)


def pa_rates(f_nt: torch.Tensor, n_pos: torch.Tensor, n_e: torch.Tensor,
             vs: torch.Tensor, gnt: torch.Tensor):
    """Annihilation sinks dne_pa, dnp_pa (pa_calc, pp2d.f:187-250) from
    the (Z, num_nt) unit-normalized electrons, the (Z, num_nt) positron
    density [cm^-3] and the (Z,) electron density. The positron sink
    multiplies n_e by the rate first: the reference's n_pos * n_e
    overflows float32 once a pair-loaded zone holds 1e29 positrons per
    unit gamma (ROADMAP C)."""
    dg = torch.diff(gnt)
    w = torch.cat([dg, dg[-1:] * 0.0])
    pa_el = torch.matmul(n_pos * w, vs.T)     # rate per electron
    pa_po = torch.matmul(f_nt * w, vs)        # rate per positron
    dne = -n_e[:, None] * f_nt * pa_el
    dnp = -n_pos * (n_e[:, None] * pa_po)
    return dne, dnp


# ---------------------------------------------------------------------------
# photon-field smoothing (nph_smooth, pp2d.f:366-457)
# ---------------------------------------------------------------------------
N_K, N_L, N_M = 21, 13, 16   # the fit grid: amplitude, index, cutoff
_CHUNK = 1 << 24             # chi^2 elements evaluated at once
_N1, _N2 = 1, 9              # 0-based counterparts of the reference's 2, 10


def fitted(nph: torch.Tensor) -> torch.Tensor:
    """The (Z,) zones of the (Z, n_gg) field with signal enough to fit
    (pp2d.f:384-386); :func:`nph_smooth` leaves the others raw."""
    return (nph[:, _N1] > 1.0) & (nph[:, _N2] > 1.0)


def nph_smooth(nph: torch.Tensor, e_gg: torch.Tensor,
               te: torch.Tensor) -> torch.Tensor:
    """Replace the noisy (Z, n_gg) MC field by the best-fit
    N (E/E_3)^-a exp(-E/E0) over a 21 x 13 x 16 parameter grid, zones
    with too little signal left unchanged (pp2d.f:377-456).

    The reference scans the candidates in flattened (k, l, m) order and
    takes a candidate when its chi^2 is <= the best so far, starting from
    1e30: the winner is the LAST candidate at the minimum, and a zone whose
    chi^2 never reaches 1e30 (or is NaN) keeps the start values. All
    candidates are evaluated at once here and that rule is applied to the
    (Z, 4368) chi^2 table."""
    Z, ngg = nph.shape
    dev = nph.device
    f32 = torch.float32
    a0 = torch.log(
        torch.clamp_min(nph[:, _N1], 1e-30)
        / torch.clamp_min(nph[:, _N2], 1e-30)
    ) / torch.log(e_gg[_N2] / e_gg[_N1])
    a0 = torch.clamp(a0, 1e-2, 4.0)
    N0 = torch.clamp_min(nph[:, 2], 1e-30)
    E00 = torch.clamp_min(te, 1.0)

    ks = torch.arange(N_K, dtype=f32, device=dev)
    ls = torch.arange(N_L, dtype=f32, device=dev)
    ms = torch.arange(N_M, dtype=f32, device=dev)
    Ns = 0.5 * N0[:, None] * 1.075 ** ks[None, :]          # (Z, 21)
    As = a0[:, None] - 0.5 + 0.05 * ls[None, :]            # (Z, 13)
    E0s = 0.35 * E00[:, None] * 1.15 ** ms[None, :]        # (Z, 16)
    e3 = e_gg[2]

    def model(N, a, E0):
        """N (E/E3)^-a / exp(min(E/E0, 20)), 0 where E/E0 >= 20; the
        arguments broadcast against a trailing n_gg axis."""
        y = e_gg / E0
        return torch.where(
            y < 20.0,
            N * (e_gg / e3) ** (-a) / torch.exp(torch.clamp_max(y, 20.0)),
            0.0,
        )

    # chi^2 over (zone, k, l, m), a chunk of zones at a time
    chi = torch.empty((Z, N_K, N_L, N_M), dtype=f32, device=dev)
    step = max(1, _CHUNK // (N_K * N_L * N_M * ngg))
    for z0 in range(0, Z, step):
        sl = slice(z0, min(Z, z0 + step))
        f_s = model(Ns[sl, :, None, None, None], As[sl, None, :, None, None],
                    E0s[sl, None, None, :, None])
        obs = nph[sl, None, None, None, :]
        use = (f_s > 1.0) & (obs > 1.0)
        chi[sl] = torch.sum(torch.where(
            use, (obs - f_s) ** 2 / torch.clamp_min(f_s, 1e-30), 0.0),
            dim=-1)
    chi = chi.reshape(Z, -1)
    chi = torch.where(torch.isnan(chi), torch.inf, chi)
    # the last minimum in flattened order: argmin of the reversed table
    n_cand = chi.shape[1]
    best = n_cand - 1 - torch.argmin(torch.flip(chi, dims=[1]), dim=1)
    took = torch.gather(chi, 1, best[:, None])[:, 0] <= 1e30
    k = best // (N_L * N_M)
    l = (best // N_M) % N_L
    m = best % N_M
    Nb = torch.where(took, torch.gather(Ns, 1, k[:, None])[:, 0], N0)
    ab = torch.where(took, torch.gather(As, 1, l[:, None])[:, 0], a0)
    Eb = torch.where(took, torch.gather(E0s, 1, m[:, None])[:, 0], E00)

    fit = model(Nb[:, None], ab[:, None], Eb[:, None])
    # zones without enough signal keep the raw field (pp2d.f:384-386)
    return torch.where(fitted(nph)[:, None], fit, nph)
