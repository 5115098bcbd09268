"""pairs_roofline_pct: the pair fields' share of their roofline, the
least time the card needs for the step's pair fields over the device
time of the program's span ``step.pairs`` (``pairs_ms``), both over the
traced stretch's steps (``harness/program_trace.py``).

Work model, from the configuration's shapes, the slots and the program's
counters ``pairs.gg_photons`` (P, the live census photons on the
gamma-gamma grid) and ``pairs.fit_zones`` (F, the zones fitted), each
summed over the stretch; Z zones, N = num_nt, G = n_gg, S slots, each
operation counted once from ``driver.pair_fields`` and
``physics/pairs.py``:

- bytes, once a step: each slot's e, w, alive, jz and kr read (17); each
  zone's tea, n_e and its electron and positron distributions read
  (2 N + 2, x 4) and its volume (4); the tables read (the pair-production
  tensor N G^2, the opacity matrix G^2, the annihilation table N^2, the
  gamma grid N and the gamma-gamma grid G, x 4); the raw and fitted
  fields, the opacity (3 Z G) and the three rates (3 Z N) written (x 4);
- operations: each photon on the grid binned (log, subtract, divide,
  floor), its count w / e and its add to the histogram (6); the field
  scaled (3 a zone and bin); ``nph_smooth``'s chi^2 over the 21 x 13 x 16
  = 4368 candidates of every zone and bin (20 a term: the model's 11 --
  E / E0, its test, E / E3, the power as log, product and exp, the
  clamp, the exp, the product, the quotient, the choice -- and the
  chi^2's 9 -- two tests and their and, difference, square, clamp,
  quotient, choice, sum) and the fitted model of the fitted zones (11 a
  bin); the opacity matmul (2 Z G^2); ``dn_pp``'s two contractions
  (2 Z N G^2, then 2 Z N G); ``pa_rates``' two matmuls (2 Z N^2 each) and
  its 8 products and sums a zone and bin.
"""
from pathlib import Path

from harness import peaks, program_trace

ROOT = Path(__file__).resolve().parent.parent

CANDIDATES = 21 * 13 * 16
CHI2_TERM = 20
MODEL_TERM = 11
PHOTON = 6
SLOT_BYTES = 4 + 4 + 1 + 4 + 4


def bound_s(g, slots: int, steps: int, gg_photons: int,
            fit_zones: int) -> float:
    """The least time for ``steps`` steps of the pair fields."""
    z, n, gg = g.nz * g.nr, g.num_nt, g.n_gg
    nbytes = steps * (slots * SLOT_BYTES + z * (2 * n + 2) * 4 + z * 4
                      + (n * gg * gg + gg * gg + n * n + n + gg) * 4
                      + (3 * z * gg + 3 * z * n) * 4)
    flops = (gg_photons * PHOTON + fit_zones * gg * MODEL_TERM
             + steps * (z * gg * 3 + z * CANDIDATES * gg * CHI2_TERM
                        + 2 * z * gg * gg + 2 * z * n * gg * gg
                        + 2 * z * n * gg + 4 * z * n * n + 8 * z * n))
    return peaks.bound_s(flops, nbytes)


def _pct(m, rec):
    snap = rec["snapshot"]
    span = snap["spans"].get("step.pairs")
    counts = snap["counts"]
    if span is None or not span["device_ms"] or not all(
            k in counts for k in ("pairs.gg_photons", "pairs.fit_zones")):
        return None
    t = bound_s(m.cfg.grid, m.cfg.run.n_slots, rec["steps"],
                counts["pairs.gg_photons"], counts["pairs.fit_zones"])
    return 100.0 * t / (span["device_ms"] * 1e-3)


def read(m):
    rec = program_trace.record(m, ROOT)
    return None if rec is None else _pct(m, rec)
