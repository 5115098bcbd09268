"""A copy of the reference's jax-free
``compton2d_tpu.units``, so that the port imports nothing
of the JAX package. Keep the two in step.

Unit scaling for float32-only device arithmetic.

All device arrays are float32; cgs magnitudes in this problem domain
(erg energies up to ~1e60, cm^3 volumes ~1e45) exceed the f32 range, so
the device works in scaled units:

- lengths in units of ``L`` [cm]  (default: max(r_max, z_max)),
- energies in units of ``E`` [erg] (RunConfig.energy_scale),
- times in seconds (magnitudes are f32-safe).

The :class:`Scales` object carries the scales and the derived
fold-factors as *Python floats* (host double precision). Every physics
constant that would overflow f32 when combined with scaled arrays is
pre-combined here; device code multiplies small folded constants first
so no traced intermediate leaves the f32 range.
"""
from __future__ import annotations

from dataclasses import dataclass

from c2dref import constants as cn


@dataclass(frozen=True)
class Scales:
    L: float          # length unit [cm]
    E: float          # energy unit [erg]

    # ---- derived (python-float, computed in f64 on host) -------------
    @property
    def L2(self) -> float:
        return self.L * self.L

    @property
    def L3(self) -> float:
        return self.L ** 3

    @property
    def c(self) -> float:
        """Speed of light in L per second."""
        return cn.C_LIGHT / self.L

    @property
    def inv_c(self) -> float:
        """Seconds per scaled length unit (time of flight)."""
        return self.L / cn.C_LIGHT

    @property
    def sigma_sb(self) -> float:
        """sigma_SB * L^2 / E: blackbody surface power for scaled areas,
        scaled-energy output [E / (L^2 s keV^4)]."""
        return cn.SIGMA_SB_KEV * self.L2 / self.E

    @property
    def mec2_vol(self) -> float:
        """m_e c^2 * L^3 / E: electron rest energy per (density x scaled
        volume), scaled-energy output."""
        return cn.MEC2_ERG * self.L3 / self.E

    @property
    def nfield_to_dgic(self) -> float:
        """Converts the scaled radiation-field tally
        n_scaled = sum(w_scaled / E_keV) into the absolute photon count
        per scaled volume used by dg_ic:
        count = n_scaled * E * PHOTONS_PER_ERG_KEV, and dg_ic divides by
        vol_cm^3 = vol_scaled * L^3."""
        return self.E * cn.PHOTONS_PER_ERG_KEV / self.L3

    @property
    def erg(self) -> float:
        """Scaled-energy unit -> erg (host conversions)."""
        return self.E


def make_scales(z_max: float, r_max: float, energy_scale: float) -> Scales:
    return Scales(L=float(max(z_max, r_max)), E=float(energy_scale))
