"""Hybrid thermal + nonthermal electron distributions (counterpart of
``compton2d_tpu.physics.electron_dist``).

Host numpy builders (``gnt_grid``, ``gamma_bar_np``) are copies of the
reference's, so the tables they feed are bitwise equal; the per-zone
functions are batched PyTorch over zones.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from c2dref import constants as cn


def gnt_grid(num_nt: int = cn.NUM_NT) -> np.ndarray:
    """Log grid in gamma-1: gnt[0] = 0.2/1.1, gnt[i] = 0.2*1.1^(i-1)."""
    i = np.arange(num_nt)
    return cn.GNT_FIRST * cn.GNT_RATIO ** (i - 1.0)


def _left_weights(gnt: torch.Tensor) -> torch.Tensor:
    """Left-rectangle weights diff(gnt) with a zero last bin."""
    dg = torch.diff(gnt)
    return torch.cat([dg, dg[-1:] * 0.0])


def maxwell_juttner_shape(gnt, theta):
    """Unnormalized g^2 beta exp(-(g-1)/Theta) on the gamma-1 grid."""
    g = gnt + 1.0
    beta = torch.sqrt(torch.clamp_min(1.0 - 1.0 / (g * g), 0.0))
    y = gnt / theta
    return torch.where(y < 100.0, g * g * beta * torch.exp(-y), 0.0)


def init_f_nt(gnt, tea, amxwl, gmin, gmax, p_nth):
    """Initial hybrid distribution with unit integral sum f dgamma,
    shape (nz, nr, num_nt) (nontherm2d.f:57-125)."""
    theta = (tea / cn.EMASS_KEV)[..., None]
    g = gnt + 1.0
    w = _left_weights(gnt)
    th = maxwell_juttner_shape(gnt, theta)
    th = torch.where(g < gmin[..., None], th, 0.0)
    th_norm = torch.clamp_min(torch.sum(th * w, dim=-1, keepdim=True), 1e-30)
    th = th / th_norm
    p1 = 1.0 - p_nth[..., None]
    n_nth = p1 / (gmax[..., None] ** p1 - gmin[..., None] ** p1)
    y = g / gmax[..., None]
    pl = torch.where(
        (g >= gmin[..., None]) & (y < 100.0),
        n_nth * g ** (-p_nth[..., None]) * torch.exp(-y),
        0.0,
    )
    a = amxwl[..., None]
    f = torch.where(a > 1e-4, a * th, 0.0) + torch.where(
        a < 0.99999999, (1.0 - a) * pl, 0.0
    )
    norm = torch.clamp_min(torch.sum(f * w, dim=-1, keepdim=True), 1e-30)
    return f / norm


def build_cdf(f_nt, gnt):
    """Sampling CDF over the gamma grid, normalized to 1 in the last bin."""
    dg = torch.diff(gnt)
    cdf = torch.cumsum(f_nt[..., :-1] * dg, dim=-1)
    total = torch.clamp_min(cdf[..., -1:], 1e-30)
    cdf = cdf / total
    return torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)


# ---------------------------------------------------------------------------
# mean thermal Lorentz factor and its inverse
# ---------------------------------------------------------------------------
def _mcdonald_np(nu: float, z: np.ndarray) -> np.ndarray:
    """Modified Bessel K_nu(z) by the reference's integral representation
    (volume2d.f:599-636), host numpy."""
    from math import gamma as gamma_fn, pi, sqrt

    t = np.geomspace(1.0, 1e4, 20000)
    ts = np.sqrt(t[1:] * t[:-1])
    dt = np.diff(t)
    z = np.atleast_1d(np.asarray(z, np.float64))
    y = z[:, None] * ts[None, :]
    integrand = np.where(
        y < 700.0, (ts**2 - 1.0) ** (nu - 0.5) * np.exp(-y), 0.0
    )
    integral = np.sum(integrand * dt[None, :], axis=-1)
    pref = sqrt(pi) * (0.5 * z) ** nu / gamma_fn(nu + 0.5)
    return pref * integral


def gamma_bar_np(theta: np.ndarray) -> np.ndarray:
    """<gamma> - Theta of a Maxwell-Juttner distribution (volume2d.f:
    572-594): Pade fit below Theta=0.2, K3/K2 - Theta above."""
    theta = np.asarray(theta, np.float64)
    fit = (
        (1.0 + 4.375 * theta + 7.383 * theta**2 + 3.384 * theta**3)
        / (1.0 + 1.875 * theta + 0.8203 * theta**2)
        - theta
    )
    k2 = _mcdonald_np(2.0, 1.0 / np.maximum(theta, 1e-10))
    k3 = _mcdonald_np(3.0, 1.0 / np.maximum(theta, 1e-10))
    with np.errstate(invalid="ignore", divide="ignore"):
        exact = k3 / np.maximum(k2, 1e-30) - theta
    out = np.where(theta < 0.2, fit, exact)
    return np.maximum(out, 1.0)


def interp(x, xp, fp):
    """``jnp.interp`` semantics: linear, clamped to fp[0] / fp[-1]."""
    i = torch.clamp(
        torch.searchsorted(xp, x.contiguous(), right=True), 1, xp.shape[0] - 1
    )
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(
        dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df
    )
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class GammaBarTable(NamedTuple):
    """Monotone f32 table of gamma_bar(Theta) for forward/inverse lookup."""

    log_theta: torch.Tensor
    gbar: torch.Tensor
    log_gbar_m1: torch.Tensor

    @classmethod
    def build(cls, theta_min=1e-4, theta_max=30.0, n=512,
              device="cpu") -> "GammaBarTable":
        log_theta = np.linspace(np.log(theta_min), np.log(theta_max), n)
        gbar = np.maximum.accumulate(gamma_bar_np(np.exp(log_theta)))

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return cls(
            log_theta=t(log_theta),
            gbar=t(gbar),
            log_gbar_m1=t(np.log(np.maximum(gbar - 1.0, 1e-12))),
        )

    def forward(self, theta):
        return interp(torch.log(theta), self.log_theta, self.gbar)

    def inverse(self, gbar):
        """Theta such that gamma_bar(Theta) = gbar (clipped to table)."""
        lg = torch.log(torch.clamp_min(gbar - 1.0, 1e-12))
        return torch.exp(interp(lg, self.log_gbar_m1, self.log_theta))
