"""tracking_roofline_pct: tracking's share of its roofline, the least
time the card needs to move the step's photons, tables and tallies over
``transport_ms``.

Work model, bytes only (the flight is bound by memory), from the
configuration's shapes and the photons tracked (``n_tracked``, summed
over the window's steps):

- each tracked photon's state read once (9 float32 fields, 2 int32 zone
  indices and the alive flag: 45 bytes) and written once (less the
  birth weight: 41 bytes);
- once a step, the zone tables read (sigma and kappa on the n_vol grid,
  the electron CDF on the num_nt grid, the zone edges, the gamma grid)
  and the tallies written (deposit, pressure, census energy and count a
  zone, the radiation field on the nphfield grid, the escaping spectrum
  (nmu x nphtotal), the light curves (nmu x bands), the four boundary
  leaks, e_ic and n_esp on the num_nt grid).
"""
from harness import peaks

PHOTON_READ, PHOTON_WRITE = 45, 41


def read(m):
    g = m.cfg.grid
    z, nt = g.nz * g.nr, g.num_nt
    tables = 4 * (z * 2 * g.n_vol + z * nt + g.nz + g.nr + 2 + nt)
    tallies = 4 * (4 * z + z * g.nphfield + g.nmu * g.nphtotal
                   + g.nmu * g.nph_lc + 2 * g.nz + 2 * g.nr + 2 * nt)
    # on several ranks each tracks its share of the photons
    nbytes = (m.histories / m.world * (PHOTON_READ + PHOTON_WRITE)
              + m.steps * (tables + tallies))
    t = m.spans_ms["tracking"] * 1e-3
    if t <= 0:
        return None
    return 100.0 * peaks.bound_s(0.0, nbytes) / t
