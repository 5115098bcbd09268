"""Census population control (counterpart of
``compton2d_tpu.transport.population``).

:func:`census_roulette` is the weight-window Russian roulette: when
alive-slot occupancy exceeds ``hi`` (or the free slots cannot hold this
step's emission), pick the roulette weight ``wc`` for which the expected
survivor count is the target; each photon survives with probability
min(1, w/wc) at weight max(w, wc). The realized energy delta is returned
so the audit stays exact. :func:`zone_sort` orders the slots by zone
bucket for the flight kernel's windowed mode.
"""
from __future__ import annotations

import torch

from compton2d_tpu_torch import telemetry as tm
from compton2d_tpu_torch.state import PhotonArray


def _roulette_weight(w, alive, target):
    """32 log-scale bisection rounds for sum(min(1, w/wc)) = target."""
    w = torch.where(alive, w, 0.0).to(torch.float32)
    total = torch.sum(w)
    lo = torch.full((), 1e-30, dtype=torch.float32, device=w.device)
    hi = torch.clamp_min(total / torch.clamp_min(target, 1.0), 2e-30)
    for _ in range(32):
        mid = torch.sqrt(lo * hi)
        cnt = torch.sum(torch.clamp_max(w / mid, 1.0))
        more = cnt > target
        lo, hi = torch.where(more, mid, lo), torch.where(more, hi, mid)
    return torch.sqrt(lo * hi)


def zone_sort(photons: PhotonArray, nz: int, nr: int,
              bucket_z: int) -> PhotonArray:
    """Stable sort of the photon slots by zone bucket ``zid // bucket_z``
    with the dead slots in a last bucket, so that the flight kernel's
    1024-slot tiles are zone-coherent (its windowed mode gives each tile a
    2 * bucket_z-zone window) and emission fills the free tail in zone
    order. The reference builds the same permutation from one-hot
    cumsums; here it is one stable argsort."""
    nzr = nz * nr
    n_b = -(-nzr // bucket_z) + 1
    zid = (torch.clamp(photons.jz, 0, nz - 1) * nr
           + torch.clamp(photons.kr, 0, nr - 1))
    bucket = torch.where(photons.alive,
                         torch.div(zid, bucket_z, rounding_mode="floor"),
                         n_b - 1)
    src = torch.argsort(bucket, stable=True)
    return PhotonArray(*(a[src] for a in photons))


def census_roulette(photons: PhotonArray, u: torch.Tensor,
                    occupancy_hi: float, target: torch.Tensor,
                    n_reserve=None):
    """Returns (photons, e_rr, n_rolled). ``u`` holds one uniform [0, 1)
    per slot; ``target`` is the survivors aimed at, occupancy_lo times
    the slots as a float32 scalar on their device (a run makes it once).
    The trigger is read on the host and the roulette runs only when it
    fires."""
    n = photons.n_slots
    i32 = torch.int32
    n_alive = torch.sum(photons.alive.to(i32), dtype=i32)
    trigger = n_alive > int(occupancy_hi * n)
    if n_reserve is not None:
        need = n_reserve.to(i32)
        trigger = trigger | (n - n_alive < need)
        target = torch.clamp(
            torch.minimum(
                target,
                (n - need - torch.div(need, 8, rounding_mode="floor"))
                .to(torch.float32),
            ),
            float(n // 8), float(n),
        )
    zero_e = torch.zeros((), dtype=torch.float32, device=u.device)
    zero_n = torch.zeros((), dtype=i32, device=u.device)
    if not tm.read("census.trigger", trigger, bool):
        return photons, zero_e, zero_n
    ph = photons
    wc = _roulette_weight(ph.w, ph.alive, target)
    p = torch.clamp_max(ph.w / wc, 1.0)
    survive = ph.alive & (u < p)
    w_new = torch.where(survive, torch.maximum(ph.w, wc), 0.0)
    e_rr = torch.sum(torch.where(ph.alive, ph.w, 0.0)) - torch.sum(w_new)
    n_rolled = torch.sum((ph.alive & ~survive).to(i32), dtype=i32)
    ph = ph._replace(w=torch.where(ph.alive, w_new, ph.w), alive=survive)
    return ph, e_rr, n_rolled
