"""Chang-Cooper discretization and batched tridiagonal solves
(counterpart of ``compton2d_tpu.fp.chang_cooper``).

``pcr_solve`` (parallel cyclic reduction) is the solver of the main path;
``thomas_solve`` (update2d.f:2476-2518) is kept as the test oracle.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _w_over_expm1(w):
    """w / (e^w - 1), stable for |w| -> 0 and large |w|. Below w = -500,
    where e^w underflows, it is its limit -w, so that w / (1 - e^-w) =
    w + w / (e^w - 1) goes to 0 there and not to w + 500 < 0. (The
    reference clips w to -500 in both, which makes the off-diagonal
    coefficient c positive and b negative under a strong heating drift;
    the tridiagonal solve then divides by a zero pivot.)"""
    wc = torch.clamp(w, -500.0, 500.0)
    small = torch.abs(wc) < 1e-8
    safe = torch.where(small, 1.0, wc)
    out = torch.where(small, 1.0 - 0.5 * wc, safe / torch.expm1(safe))
    return torch.where(w < -500.0, -w, out)


def _w_over_one_minus_exp_neg(w):
    """w / (1 - e^-w) = w + w/(e^w - 1)."""
    return w + _w_over_expm1(w)


def grid_spacing(gnt) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The (num_nt,) rows d_gm, d_gp (the spacings below and above each
    bin, the end bins' copied from their neighbours) and delta_g of the
    Chang-Cooper discretization (update2d.f:1363-1367)."""
    d_gm = torch.cat([gnt[1:2] - gnt[0:1], gnt[1:] - gnt[:-1]])
    d_gp = torch.cat([gnt[1:] - gnt[:-1], gnt[-1:] - gnt[-2:-1]])
    delta_g = torch.sqrt(gnt / torch.cat([gnt[0:1], gnt[:-1]])) * d_gm
    return d_gm, d_gp, delta_g


def chang_cooper_coeffs(gnt, dgdt, disp, d_t, t_esc
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tridiagonal coefficients (a, b, c), shapes (..., num_nt)
    (update2d.f:1363-1390). ``t_esc`` is a float, or a tensor on the
    device of ``d_t``: a float is a copy from the host on each call."""
    num_nt = gnt.shape[0]
    d_gm, d_gp, delta_g = grid_spacing(gnt)

    dgdt_p1 = torch.roll(dgdt, -1, dims=-1)
    disp_p1 = torch.roll(disp, -1, dims=-1)
    big_b = -(dgdt + dgdt_p1) / 2.0
    big_c = torch.clamp_min((disp + disp_p1) / 2.0, 1e-30)
    # the reference's index-1 seed lacks the 1/2 on B (update2d.f:1369)
    big_b = big_b.clone()
    big_b[..., 0] = -(dgdt[..., 0] + dgdt[..., 1])
    smw = d_gp * big_b / big_c
    big_w = _w_over_expm1(smw)
    w_pos = _w_over_one_minus_exp_neg(smw)

    dt_e = torch.as_tensor(d_t)[..., None]
    c = -dt_e * big_c * w_pos / (delta_g * d_gp)
    big_c_m1 = torch.roll(big_c, 1, dims=-1)
    big_w_m1 = torch.roll(big_w, 1, dims=-1)
    w_pos_m1 = torch.roll(w_pos, 1, dims=-1)
    b = (
        1.0
        + dt_e / delta_g * (
            big_c * big_w / d_gp + big_c_m1 * w_pos_m1 / d_gm
        )
        + dt_e / torch.as_tensor(t_esc, dtype=dt_e.dtype,
                                 device=dt_e.device)[..., None]
    )
    a = -dt_e / delta_g * big_c_m1 * big_w_m1 / d_gm
    # boundary rows (update2d.f:1319-1324)
    a = a.clone()
    b = b.clone()
    c = c.clone()
    a[..., 0] = 0.0
    a[..., num_nt - 1] = 0.0
    b[..., 0] = 1.0
    b[..., num_nt - 1] = 1.0
    c[..., 0] = 0.0
    c[..., num_nt - 1] = 0.0
    return a, b, c


def _shift(x, s: int, fill: float):
    """x shifted by s along the last axis (s > 0: neighbor i-s)."""
    pad = torch.full_like(x[..., :abs(s)], fill)
    if s > 0:
        return torch.cat([pad, x[..., :-s]], dim=-1)
    return torch.cat([x[..., -s:], pad], dim=-1)


def pcr_solve(a, b, c, d, clamp_negative: bool = True):
    """Parallel cyclic reduction along the last axis: ceil(log2 N)
    full-width rounds. Stable for the strictly diagonally dominant
    Chang-Cooper systems."""
    n = a.shape[-1]
    steps = max(1, (n - 1).bit_length())
    s = 1
    for _ in range(steps):
        b_m = _shift(b, s, 1.0)
        b_p = _shift(b, -s, 1.0)
        alpha = -a / b_m
        gamma = -c / b_p
        a_n = alpha * _shift(a, s, 0.0)
        c_n = gamma * _shift(c, -s, 0.0)
        b_n = b + alpha * _shift(c, s, 0.0) + gamma * _shift(a, -s, 0.0)
        d_n = d + alpha * _shift(d, s, 0.0) + gamma * _shift(d, -s, 0.0)
        a, b, c, d = a_n, b_n, c_n, d_n
        s *= 2
    out = d / torch.where(torch.abs(b) < 1e-30, 1e-30, b)
    return torch.clamp_min(out, 0.0) if clamp_negative else out


def thomas_solve(a, b, c, d, clamp_negative: bool = True):
    """Batched Thomas algorithm along the last axis (the test oracle)."""
    n = a.shape[-1]
    tiny = torch.tensor(1e-30, dtype=b.dtype, device=b.device)
    bet = torch.where(torch.abs(b[..., 0]) < 1e-30, tiny, b[..., 0])
    fs = [d[..., 0] / bet]
    gams = [torch.zeros_like(bet)]
    for i in range(1, n):
        gam = c[..., i - 1] / bet
        bet = b[..., i] - a[..., i] * gam
        bet = torch.where(torch.abs(bet) < 1e-30, tiny, bet)
        fs.append((d[..., i] - a[..., i] * fs[-1]) / bet)
        gams.append(gam)
    out = [None] * n
    out[n - 1] = fs[n - 1]
    for i in range(n - 2, -1, -1):
        out[i] = fs[i] - gams[i + 1] * out[i + 1]
    res = torch.stack(out, dim=-1)
    return torch.clamp_min(res, 0.0) if clamp_negative else res
