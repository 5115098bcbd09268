"""volume_em_roofline_pct: the zone pass's share of its roofline, the
least time the card needs for the step's emissivities over
``volume_em_ms``.

Work model, from the configuration's shapes only (Z zones, on several ranks with the zone farm
this rank's slice of them, V = n_vol
photon bins, N = num_nt electron bins), once a step:

- operations: 90 for each (zone, photon bin, electron bin): the
  synchrotron kernel's argument, its two Bessel fits and the spectral
  shape (79, both branches of each fit, every arithmetic operation and
  transcendental of ``physics.emissivity.sync_kernel_f32`` counted once)
  and the emission and absorption sums (4) with the argument's products;
- bytes: each zone's distribution and 13 zone scalars read, its
  absorption and two emission CDFs written (3 V x 4), and the photon and
  electron grids read once.
"""
from harness import peaks

PER_ELEMENT = 90


def read(m):
    g = m.cfg.grid
    z, v, n = g.nz * g.nr, g.n_vol, g.num_nt
    if m.world > 1 and m.cfg.run.zone_shard:
        z = -(-z // m.world)          # this rank's slice of the zones
    flops = m.steps * z * v * n * PER_ELEMENT
    nbytes = m.steps * (z * (n * 4 + 13 * 4 + 3 * v * 4) + (v + n) * 4)
    t = m.spans_ms["zone_pass"] * 1e-3
    if t <= 0:
        return None
    return 100.0 * peaks.bound_s(flops, nbytes) / t
