"""fp_roofline_pct: the FP solve's share of its roofline, the least time
the card needs for the step's FP work over ``fp_step_ms``.

Work model, from the configuration's shapes and the step's substeps only
(Z zones, on several ranks with the zone farm
this rank's slice of them, N = num_nt electron bins, P = nphfield field bins, S the step's
``fp_substeps``, summed over the window's steps):

- bytes, once a step: each zone's distribution read and written
  (2 N x 4), its radiation field read (P x 4) and 16 zone scalars read
  or written (16 x 4);
- operations: the inverse-Compton cooling contraction once a step
  (2 P N a zone), and each substep 60 a bin of each zone: the Chang-Cooper
  coefficients and the drift and dispersion terms (52, every arithmetic
  operation and transcendental of ``fp.chang_cooper`` and the substep's
  terms counted once) and one tridiagonal solve (8, Thomas's count, the
  least a solve needs).
"""
from harness import peaks

PER_BIN_SUBSTEP = 60


def read(m):
    g = m.cfg.grid
    z, n, p = g.nz * g.nr, g.num_nt, g.nphfield
    if m.world > 1 and m.cfg.run.zone_shard:
        z = -(-z // m.world)          # this rank's slice of the zones
    nbytes = m.steps * z * (2 * n * 4 + p * 4 + 16 * 4)
    flops = m.steps * z * 2 * p * n + m.fp_substeps * z * n * PER_BIN_SUBSTEP
    t = m.spans_ms["fp"] * 1e-3
    if t <= 0 or m.fp_substeps <= 0:
        return None
    return 100.0 * peaks.bound_s(flops, nbytes) / t
