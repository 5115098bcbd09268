"""A copy of the reference's jax-free
``compton2d_tpu.constants``, so that the port imports nothing
of the JAX package. Keep the two in step.

Physical constants and default grid sizes.

Mirrors the compile-time parameters of the reference
(``reference/src/general.pa:7-31``) but here they are *defaults*, not
hard compile-time ceilings — every size is configurable per run through
:class:`compton2d_tpu.config.SimConfig`.

All units cgs + keV (photon/electron energies in keV, as in the reference).
"""

# ---------------------------------------------------------------------------
# Physical constants (cgs / keV)
# ---------------------------------------------------------------------------
PI = 3.1415926536
C_LIGHT = 2.9979245620e10        # cm/s                (general.pa:26)
RAD_CP = 3.333564097e-11         # 1/c  [s/cm]         (general.pa:24)
EMASS_KEV = 511.0                # electron rest mass [keV]
SIGMA_THOMSON = 6.6524616e-25    # cm^2
ERG_PER_KEV = 1.602176634e-9     # erg / keV
# The reference uses 8.176e-7 erg for m_e c^2 when auditing electron energy
# (update2d.f:495) and 1.957e-3 = 1/511 for keV->mc^2. Keep its value for
# parity of the energy audit.
MEC2_ERG = 8.176e-7              # m_e c^2 in erg (reference value)
KEV_TO_MEC2 = 1.0 / 511.0
# Stefan-Boltzmann constant expressed for T in keV: sigma_SB * (keV/k_B)^4
# = 5.6704e-5 erg/cm^2/s/K^4 * (1.16045e7 K/keV)^4 = 1.0279e24
# erg/cm^2/s/keV^4. (Used for surface blackbody energy input
# erin = dt * A * sigma * tbb^4, imcgen2d.f:131.)
SIGMA_SB_KEV = 1.02796e24        # erg cm^-2 s^-1 keV^-4
KEV_TO_KELVIN = 1.16045e7
PLANCK_H = 6.626075e-27          # erg s
E_CHARGE = 4.803e-10             # esu
E_MASS_G = 9.109e-28             # g
# Photon number weight: reference converts energy-weight (erg) to photon
# number via ew/xnu * 6.25e8 (1/ERG_PER_KEV), imctrk2d.f:543,555.
PHOTONS_PER_ERG_KEV = 6.25e8

# ---------------------------------------------------------------------------
# Default grid sizes (reference compile-time values, general.pa:10-23)
# ---------------------------------------------------------------------------
NUM_NT = 200        # electron gamma-1 log bins          (general.pa:14)
N_VOL = 400         # volume emissivity/opacity bins     (general.pa:13)
NPHFIELD = 400      # soft radiation field bins          (general.pa:15)
N_GG = 100          # gamma-gamma opacity bins           (general.pa:18)
N_REF = 500         # Compton reflection bins            (general.pa:19)
NMU_MAX = 32        # angular bins                       (general.pa:20)
NPHO_MAX = 128      # spectral output bins               (general.pa:21)
NPHLC_MAX = 10      # light-curve bands                  (general.pa:22)
NREG_MAX = 5        # spectral energy regions            (general.pa:23)
NT_MAX = 100        # boundary-condition time windows    (general.pa:12)

# FP solver tolerances (general.pa:27-28)
DF_IMPLICIT = 1.0e-2
DF_T = 0.25

# Electron gamma-1 grid: gnt(1) = 0.2, ratio 1.1  (nontherm2d.f:52-54,87-99)
GNT_FIRST = 0.2
GNT_RATIO = 1.1

# Photon-field energy grids (setup2d.f:199-222 + volume2d.f:104):
# E_ph / E_field: 400 log bins spanning 20 decades from 1e-10 keV.
EFIELD_MIN_KEV = 1.0e-10
EFIELD_DECADES = 20.0
# gamma-gamma grid: 100 log bins from 50 keV spanning a factor 100
# (setup2d.f:199-209).
EGG_MIN_KEV = 50.0
EGG_SPAN = 100.0
# Reflection grid: 500 log bins over 1..1000 keV (ref_matrix.f).
EREF_MIN_KEV = 1.0
EREF_MAX_KEV = 1000.0
