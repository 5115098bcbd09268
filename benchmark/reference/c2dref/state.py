"""Simulation state (counterpart of ``compton2d_tpu.state``).

NamedTuples of tensors with the reference's field names, shapes and
dtypes: :class:`ZoneState` per-zone fields, :class:`PhotonArray` SoA
photon slots, :class:`Tallies` per-step Monte-Carlo tallies,
:class:`EventBuffer` escaping-photon records and :class:`SimState`.
Photon fields are float32 energy weights in units of the run's energy
scale; zone fields are float32.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from c2dref.config import SimConfig


class ZoneState(NamedTuple):
    """Prognostic per-zone fields, shapes (nz, nr) / (nz, nr, num_nt)."""

    tea: torch.Tensor
    tna: torch.Tensor
    n_e: torch.Tensor
    B_field: torch.Tensor
    amxwl: torch.Tensor
    gmin: torch.Tensor
    gmax: torch.Tensor
    p_nth: torch.Tensor
    q_turb: torch.Tensor
    turb_lev: torch.Tensor
    ep_switch: torch.Tensor   # int32
    f_nt: torch.Tensor
    cdf_nt: torch.Tensor
    f_pair: torch.Tensor
    n_pos: torch.Tensor
    ec_old: torch.Tensor


class PhotonArray(NamedTuple):
    """SoA photon slots, shape (n_slots,) each (see the reference for the
    geometry convention: ``mu`` to +z, (cphi, sphi) the azimuth relative
    to the local outward radial direction)."""

    e: torch.Tensor
    w: torch.Tensor
    w0: torch.Tensor
    r: torch.Tensor
    z: torch.Tensor
    mu: torch.Tensor
    cphi: torch.Tensor
    sphi: torch.Tensor
    dcen: torch.Tensor
    jz: torch.Tensor      # int32
    kr: torch.Tensor      # int32
    alive: torch.Tensor   # bool

    @property
    def n_slots(self) -> int:
        return self.e.shape[0]

    @classmethod
    def empty(cls, n_slots: int, device="cpu") -> "PhotonArray":
        def zf():
            return torch.zeros(n_slots, dtype=torch.float32, device=device)

        def zi():
            return torch.zeros(n_slots, dtype=torch.int32, device=device)

        return cls(
            e=zf(), w=zf(), w0=zf(), r=zf(), z=zf(), mu=zf(),
            cphi=torch.ones(n_slots, dtype=torch.float32, device=device),
            sphi=zf(), dcen=zf(), jz=zi(), kr=zi(),
            alive=torch.zeros(n_slots, dtype=torch.bool, device=device),
        )


class Tallies(NamedTuple):
    """Per-step tallies (f32 accumulators, scaled units)."""

    edep: torch.Tensor
    prdep: torch.Tensor
    ecens: torch.Tensor
    npcen: torch.Tensor
    n_field: torch.Tensor
    n_ph: torch.Tensor
    e_ic: torch.Tensor
    n_esp: torch.Tensor
    fout: torch.Tensor
    edout: torch.Tensor
    erlk_inner: torch.Tensor
    erlk_outer: torch.Tensor
    erlk_upper: torch.Tensor
    erlk_lower: torch.Tensor
    ed_in: torch.Tensor
    ed_ref: torch.Tensor
    e_killed: torch.Tensor
    e_scatter: torch.Tensor
    e_pair_abs: torch.Tensor
    e_src_lost: torch.Tensor
    e_rr: torch.Tensor
    n_rr: torch.Tensor            # int32
    trk_rounds: torch.Tensor      # int32
    n_sct_overflow: torch.Tensor  # int32
    # the port's own counters (int32): lanes frozen with FLAG_WINDOW by
    # the windowed flight kernel, summed over rounds, and the live photons
    # sent to census with flight distance left at the iteration budget;
    # the lanes reflected at the lower boundary (sampled or mirrored,
    # cr_sent 1/3/4) and the photons reflected off the outer disk and
    # recorded (cr_sent 2/3)
    n_window: torch.Tensor
    n_straggler: torch.Tensor
    n_reflect_lower: torch.Tensor
    n_reflect_disk: torch.Tensor

    @classmethod
    def zeros(cls, nz, nr, num_nt, nphfield, n_gg, nmu, nphtotal, nph_lc,
              device="cpu") -> "Tallies":
        def f(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        def i():
            return torch.zeros((), dtype=torch.int32, device=device)

        return cls(
            edep=f(nz, nr), prdep=f(nz, nr), ecens=f(nz, nr),
            npcen=f(nz, nr), n_field=f(nz, nr, nphfield),
            n_ph=f(nz, nr, n_gg), e_ic=f(num_nt), n_esp=f(num_nt),
            fout=f(nmu, nphtotal), edout=f(nmu, nph_lc),
            erlk_inner=f(nz), erlk_outer=f(nz), erlk_upper=f(nr),
            erlk_lower=f(nr), ed_in=f(nr), ed_ref=f(nr),
            e_killed=f(), e_scatter=f(), e_pair_abs=f(), e_src_lost=f(),
            e_rr=f(), n_rr=i(), trk_rounds=i(), n_sct_overflow=i(),
            n_window=i(), n_straggler=i(), n_reflect_lower=i(),
            n_reflect_disk=i(),
        )


class EventBuffer(NamedTuple):
    """Escaping-photon records (t_bound, xnu, ew, rpre, zpre, wmu, phi)."""

    data: torch.Tensor     # (capacity, 7) float32
    count: torch.Tensor    # (1,) int32, may exceed capacity

    @classmethod
    def empty(cls, capacity: int, device="cpu") -> "EventBuffer":
        return cls(
            data=torch.zeros((capacity, 7), dtype=torch.float32,
                             device=device),
            count=torch.zeros((1,), dtype=torch.int32, device=device),
        )


class SimState(NamedTuple):
    """Full simulation state advanced by one step. ``key`` is the port's
    random stream, a ``torch.Generator`` on the state's device (the
    reference keeps a threefry key here)."""

    zones: ZoneState
    photons: PhotonArray
    time: torch.Tensor       # () float32 [s]
    dt: torch.Tensor         # () float32
    dt_prev: torch.Tensor    # () float32
    ncycle: torch.Tensor     # () int32
    key: torch.Generator
    ed_abs: torch.Tensor     # (nr,)
    ed_ref: torch.Tensor     # (nr,)
    k_gg: torch.Tensor       # (nz, nr, n_gg)
    dn_pp: torch.Tensor      # (nz, nr, num_nt)
    dne_pa: torch.Tensor
    dnp_pa: torch.Tensor


def init_zone_state(cfg: SimConfig, zone_init, tables) -> ZoneState:
    """Initial ZoneState from per-zone initial conditions
    (setup2d.f:122-139), on the device of ``tables``."""
    from c2dref.physics import electron_dist as ed

    dev = tables.gnt.device

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    tea, amxwl = f(zone_init.tea), f(zone_init.amxwl)
    gmin, gmax = f(zone_init.gmin), f(zone_init.gmax)
    p_nth = f(zone_init.p_nth)
    f_nt = ed.init_f_nt(tables.gnt, tea, amxwl, gmin, gmax, p_nth)
    shape = tuple(tea.shape)
    num_nt = tables.gnt.shape[0]
    zeros = torch.zeros(shape, dtype=torch.float32, device=dev)
    return ZoneState(
        tea=tea,
        tna=f(zone_init.tna),
        n_e=f(zone_init.n_e),
        B_field=f(zone_init.B_field),
        amxwl=amxwl,
        gmin=gmin,
        gmax=gmax,
        p_nth=p_nth,
        q_turb=f(zone_init.q_turb),
        turb_lev=f(zone_init.turb_lev),
        ep_switch=torch.as_tensor(
            np.asarray(zone_init.ep_switch, np.int32), device=dev
        ),
        f_nt=f_nt,
        cdf_nt=ed.build_cdf(f_nt, tables.gnt),
        f_pair=zeros.clone(),
        n_pos=torch.zeros(shape + (num_nt,), dtype=torch.float32, device=dev),
        ec_old=zeros.clone(),
    )
