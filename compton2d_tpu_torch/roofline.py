"""The byte and operation model of the port's tracking phase (the
counterpart of ``tools/roofline.py``).

Two models, one byte count:

- :func:`flight_bound`: the least time of one flight-kernel entry on
  given inputs (``chip_smoke.py`` phase 2 reports it as each kernel
  mode's ``bound_ms``): the larger of the bytes the function must move
  over the card's HBM rate and its operations over the float32 rate;
- :func:`round_bytes`: the bytes of one tracking round of a step (one
  kernel entry at those bytes, plus the ``_leak`` pass that reads and
  writes the photon SoA once more), which times the rounds of a step
  gives the tracking phase's least time (:func:`tracking_bound_ms`;
  ``chip_smoke.py`` phase 3 reads it from the main path's run).

And the FP solve's (``chip_smoke.py`` phase 13): :func:`fp_bound`, the
work model of the benchmark's ``fp_roofline_pct`` for one step, and
:func:`fp_kernel_bound`, the substep kernel's own work; the zone pass's
(phase 14): :func:`volume_em_bound`, the work model of the benchmark's
``volume_em_roofline_pct``.
"""
from __future__ import annotations

from compton2d_tpu_torch.transport import flight

# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# operations of one lane-iteration in each state of the flight kernel,
# counted from csrc/flight.cu (arithmetic, compares and the counter hash,
# a transcendental as one): FLY rounded down; SCT_A as its CDF scan
# alone; SCT_B as its sz candidate alone. Lower counts, so the bound
# stays a least time.
OPS_FLY, OPS_SCT_A, OPS_SCT_B = 200, 20, 40
# the pair mode's kgg lookup and energy split in FLY, rounded down
OPS_GG = 15
# the photon SoA: floats and integers read by the kernel (e, w, w0, r, z,
# mu, cphi, sphi, dcen, jz, kr, alive) and written by it (those but w0
# and alive, the flag, mode, jn, kn and sct_cnt, and the per-lane sums)
SOA_IN, SOA_OUT = 12, 20
# the FP solve's operations a bin of a zone a substep: the Chang-Cooper
# coefficients with the drift and dispersion terms (52) and one
# tridiagonal solve (8, Thomas's count, the least a solve needs)
FP_OPS_BIN_SUBSTEP = 60
# the zone pass's operations a (zone, photon bin, electron bin) term: the
# synchrotron shape's argument, both branches of its two Bessel fits and
# the shape (79), the two sums (4) and the argument's products
VOLUME_EM_OPS_TERM = 90


def table_elems(tables, pairs: bool) -> int:
    """Elements of the zone tables a kernel entry reads."""
    return sum(t.numel() for t in (
        tables.sig, tables.kap, tables.cdf, tables.guide, tables.gm1,
        tables.r_edges, tables.z_edges) + ((tables.kgg,) if pairs else ()))


def kernel_bytes(n: int, nzr: int, n_table: int, log_entries: int) -> int:
    """Bytes of one kernel entry over ``n`` slots: each input read once
    (the SoA, one seed a tile, the tables), each output written once (the
    SoA, the (2, nzr) tally, 8 bytes a scatter-log entry)."""
    n_tiles = n // flight.TILE
    bytes_in = 4 * (SOA_IN * n + n_tiles + n_table)
    bytes_out = 4 * (SOA_OUT * n + 2 * nzr) + 8 * log_entries
    return bytes_in + bytes_out


def _bound(nbytes: int, ops: int) -> dict:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def flight_bound(photons, tables, res, nz: int, nr: int,
                 pairs: bool = False) -> dict:
    """The least time of one flight-kernel entry on these inputs: the
    larger of its bytes (:func:`kernel_bytes`: the strat mode writes no
    logs; the pair mode also reads the kgg table; the kernel's own
    intermediates, such as its per-block tally partials and the windowed
    mode's base blocks, are not the function's and are not counted) over
    the HBM rate and its operations over the float32 rate. The operations
    are the lower counts above times the least lane-iterations that the
    kernel's result ``res`` shows: one flight per live lane and one more
    per scatter (each with the kgg lookup in the pair mode), and one SCT_A
    and one SCT_B iteration per scatter."""
    n = photons["e"].shape[0]
    nbytes = kernel_bytes(n, nz * nr, table_elems(tables, pairs),
                          res.iglog.numel())
    live = photons["alive"] & (photons["dcen"] > 0.0)
    scatters = int(res.sct_cnt[live].sum())
    flights = int(live.sum()) + scatters
    ops = ((OPS_FLY + (OPS_GG if pairs else 0)) * flights
           + (OPS_SCT_A + OPS_SCT_B) * scatters)
    return _bound(nbytes, ops)


def round_bytes(sim) -> int:
    """Bytes of one tracking round of ``sim``'s step: a kernel entry over
    the rank's slots with the tables of its grid (:func:`table_elems` of
    them: sig, kap, the CDF and the guide a zone, kgg a zone with pairs,
    the gm1 midpoints and the edges), scatter logs in the inline modes,
    and the ``_leak`` pass reading and writing the SoA once more."""
    g, phys, src = sim.cfg.grid, sim.cfg.physics, sim.cfg.source
    n = sim.state.photons.n_slots
    nzr = g.nz * g.nr
    n_table = (nzr * (2 * g.n_vol + g.num_nt + flight.GUIDE_G
                      + (g.n_gg if phys.pair_switch else 0))
               + (g.num_nt - 1) + (g.nz + 1) + (g.nr + 1))
    logs = 0 if src.strat_split else n * flight.K_LOG
    return kernel_bytes(n, nzr, n_table, logs) + leak_bytes(n)


def leak_bytes(n: int) -> int:
    """The ``_leak`` pass: the photon SoA read and written once."""
    return 2 * SOA_IN * n * 4


def tracking_bound_ms(sim, rounds_per_step: float) -> float:
    """The tracking phase's least ms per step: its rounds' bytes at the
    HBM rate."""
    return 1e3 * rounds_per_step * round_bytes(sim) / PEAK_BYTES_S


def fp_bound(zones: int, num_nt: int, nphfield: int, substeps: int) -> dict:
    """The least time of one FP step (``benchmark/metrics/
    fp_roofline_pct.py``'s model): each zone's distribution read and
    written, its radiation field and 16 scalars read, the inverse-Compton
    contraction (2 nphfield num_nt a zone) and FP_OPS_BIN_SUBSTEP a bin of
    every zone for each of the step's ``substeps`` (the largest zone's
    count: it charges a zone that is done for the substeps it no longer
    takes)."""
    return _bound(zones * (2 * num_nt * 4 + nphfield * 4 + 16 * 4),
                  zones * 2 * nphfield * num_nt
                  + substeps * zones * num_nt * FP_OPS_BIN_SUBSTEP)


def fp_kernel_bound(zones: int, num_nt: int, zone_substeps: int) -> dict:
    """The least time of one launch of the FP substep kernel
    (``csrc/fp_substeps.cu``): each zone's distribution and
    inverse-Compton drift read and its distribution written, 20 scalars
    read and 5 written a zone, and FP_OPS_BIN_SUBSTEP a bin of each
    substep a zone takes (``zone_substeps``, the per-zone counts summed:
    a zone that is done stops)."""
    return _bound(zones * (3 * num_nt + 25) * 4,
                  zone_substeps * num_nt * FP_OPS_BIN_SUBSTEP)


def volume_em_bound(zones: int, n_vol: int, num_nt: int) -> dict:
    """The least time of one step's zone pass (``benchmark/metrics/
    volume_em_roofline_pct.py``'s model), which the synchrotron sums
    kernel (``csrc/volume_em.cu``) does nearly all of: VOLUME_EM_OPS_TERM
    operations a term, each zone's distribution and 13 scalars read and
    its three n_vol rows written, the grids read once."""
    return _bound(zones * (num_nt + 13 + 3 * n_vol) * 4 + (n_vol + num_nt) * 4,
                  zones * n_vol * num_nt * VOLUME_EM_OPS_TERM)
