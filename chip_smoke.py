"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card::

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. card and build: the card's name and power limit, the torch / CUDA
   versions, and the nvcc build of ``csrc/flight.cu`` for sm_90a with
   ptxas's registers, stack and spills of each kernel instance, and of
   ``csrc/fp_substeps.cu`` and ``csrc/volume_em.cu``;
2. the flight kernel in its inline-scatter mode against its plain
   PyTorch version on the card, at the main path's shapes (131072 slots,
   8x4 zones, 400 energy and 200 gamma bins) with inputs made by numpy
   from a seed: the table placement (shared memory here) and the block
   plan (threads a block, blocks per SM), lane-for-lane agreement after
   one iteration (integers exact, floats rtol 1e-5), >= 99% identical
   lanes after 256, bitwise repeatability, and the times: the kernel on
   the device alone (CUDA events around 20 launches on preallocated
   outputs), the wrapper-included call, the plain version, the bound
   (``roofline.flight_bound``), and from the kernel's counters its SIMT
   efficiency (lane-iterations over 32 x warp passes);
2b. the same for the kernel's strat mode (collisions freeze with
   FLAG_SCATTER), at the Mrk 421 shapes (131072 slots, 10x4 zones, 400
   energy and 200 gamma bins), with 512 iterations;
2c. the same for the kernel's pair mode (pair_switch: gamma-gamma
   absorption on the e_gg grid, the pair share of the absorbed energy),
   at the pair corona's shapes (262144 slots, 4x3 zones, 128 energy, 100
   gamma and 32 e_gg bins), with 256 iterations, in both scatter modes
   (inline, and frozen with FLAG_SCATTER as the stratified pair corona
   runs it); after one iteration at most 1e-4 of the lanes may exceed
   rtol 1e-5, each by less than 10x its own sensitivity to 2-ulp changes
   of its inputs;
2d. the same for the kernel's windowed mode (grids above 1024 zones: a
   flying lane outside its tile's 256-zone window freezes with
   FLAG_WINDOW), at large_corona's shapes (524288 slots, 99x99 zones, 400
   energy and 200 gamma bins) with the live slots zone-sorted by the
   port's ``zone_sort`` and the free tail refilled out of zone order, as
   on the path, with 256 iterations; it counts the FLAG_WINDOW lanes,
   which must be above 0; its tables are read from global memory;
2e. the same for the resident inline mode at 32x32 zones (1024, the
   largest resident grid), 131072 slots and the main path's widths, whose
   tables are too large for shared memory and are read from global
   memory; the one-iteration tally check allows each zone 2^-22 of its
   depositing weight, as 2d's (a 2-ulp exp difference of one lane moved
   one zone's small net deposit by 2^-22 there);
3. the main path: ``small_corona`` at the benchmark size with the FP
   solve on, 2 warm-up and 8 timed steps through ``Simulation.step()``,
   checking the kernel launches, device placement, the per-step energy
   audit, finite temperatures, escapes, repeatability from the seed, and
   statistical agreement with the plain (CPU) path on a small grid; the
   roofline reading (``roofline.round_bytes`` times the run's rounds at
   the HBM rate, against the step time);
4. the Mrk 421 flare run at the width of the dense science run (10x4
   zones, 131072 slots, nst 200000, n_e 2e6, stratified splitting with
   gamma_c 3e4 and 64 copies) through ``run_to_stop`` to t_stop = 7e4 s
   with outputs attached, then the ``run_mrk421`` post-processing:
   every step's energy audit, strat-mode launches, frozen scatters and
   placed copies, the event file (written by the native formatter,
   ``io.native``, and read back by its parse as by numpy), the SED's peaks
   and its synchrotron hump's centre against the committed artifact's,
   and the observation check (``obs_compare`` against the observed points
   of the committed overlay: the X-ray median log ratio, s*, the TeV
   residual and the sync peak, which must lie in 1e-2-1e1 keV);
5. the pair corona: the reference's own pair configuration (the one
   ``tools/pallas_e2e.py`` builds: ``small_corona`` with 4x3 zones, 262144
   slots, nst 200000, a bounded nonthermal tail amxwl 0.5, gamma 3-20,
   pair_switch on), 2 warm-up and 6 timed steps through
   ``Simulation.step()``: pair-mode launches and no plain-version run,
   every step's energy audit, gamma-gamma absorption, the pair fields and
   the pair fraction, finite zone fields, repeatability from the seed;
   then its stratified variant (gamma_c 10, p_max 0.5) for 3 steps, with
   each step's tracking rounds and kernel iterations beside the zones'
   largest Thomson depth: a step of many rounds must start with a zone
   of Thomson depth above 10;
6. the large grid: ``large_corona`` (``small_corona`` at 99x99 zones,
   524288 slots, nst 240000, the main path's widths, FP on), 1 warm-up
   and 3 timed steps through ``Simulation.step()``, then the reference's
   windowed-test grid (40x30 zones, 131072 slots) for 2 steps, twice from
   the seed: windowed launches only and no plain-version run, every
   tensor on the card, every step's energy audit, finite temperatures,
   escapes, bitwise-repeatable tallies (40x30), and per step the rounds,
   the FLAG_WINDOW freezes and the stragglers sent to census, with the
   card's peak memory; then the 32x32 grid (the resident mode with its
   tables in global memory) for 2 steps;
7. the reference-format decks (``compton2d_tpu_torch.decks``), written in
   the reference's input format and loaded by the port's legacy importer
   at full width, 131072 slots and nst 60000, 2 warm-up and 6 timed steps
   each through ``Simulation.step()``: ``disk_deck`` (``small_corona``'s
   8x4 corona above a reflecting disk, cr_sent 3, a flare, adaptive dt)
   with, every step, the audit within 2e-3 once its reflection share
   sum(ed_ref) E / avail is added to 1 (the reference's audit counts a
   reflected photon twice), lower reflections, outer-disk records and a
   positive ed_ref, and the next dt: dt0 after the first step, then the
   larger of that step's FP ladder dt_new (read from the run) and
   dt_min; the flare's turb_lev boost at its peak step and zone; tallies
   bitwise repeatable over 2 steps from the seed; the disk deck again at
   mcdt 3 (dt0 = 3 dt_min) for 2 + 2 steps with the same gates, where
   the ladder's dt lies above dt_min and some step must apply it; and
   ``ec_deck`` (``blazar_jet``'s 10x5 blob lit by a diskgen file in a
   window that opens at 2 dt0) with the audit within 5e-3, the file
   input 0 in the first two steps and positive after, and energy escaping
   upward once it is on; for each the ms/step, histories/s, rounds/step,
   B1 launches per step, FP substeps and Te per step. Then the flight
   kernel against its plain version, as in phase 2, on each deck's own
   inputs of its first timed step's first round (the disk deck's 8x4
   tables in shared memory, the blazar blob's 10x5 ones in global
   memory), with its times and bound at that shape;
8. the production run: the main path's corona with the Coulomb FP drift
   (``fp_include_coulomb``; its tables built once on the host, timed), 2
   warm-up and 6 timed steps through ``Simulation.step()``: every step's
   audit within 2e-3, finite temperatures, B1 launches only (shared
   tables, no plain-version run), the ms/step, histories/s and FP
   substeps/step; the same 8 steps twice from the seed (bitwise-equal
   tallies) and once without the Coulomb terms (both mean Te and substep
   counts logged; the electron distributions must differ); ``fp_step`` on
   the run's inputs of its first timed step with and without the terms,
   6 calls each in turns; the flight kernel against its plain version, as
   in phase 2, on the run's first timed step's first round;
   ``write_diagnostics(extras=True)`` after the run and after 2 steps of
   phase 5's pair corona (every file of the reference's with its rows and
   columns); ``photon_fill_diagnostic`` with the checks of the JAX
   package's test after the first step (the cycle-1 table the reference
   computes) and, all but its net-cooling zone, after the run; then 3
   steps, ``run_to_stop`` with a spent walltime budget (a checkpoint,
   False), and 3 steps of a fresh Simulation resumed from it with the
   event file appended to, bitwise equal to 6 uninterrupted steps (every
   state tensor, the generator, each step's tallies, the event file);
9. two ranks on one card: the main path's corona sharded over 2 ranks on
   cuda:0 (spawned processes, gloo, a ``file://`` rendezvous; each rank
   65536 slots and 16 of the 32 zones in the zone farm), 2 warm-up and 4
   timed steps through ``Simulation.step()``: every step's audit on every
   rank, finite temperatures, tallies and zone state bitwise equal across
   the ranks, B1 launches on each rank and no other mode, the ms/step,
   histories/s, the collective's ms per step and FP substeps, and the
   collectives census (``collectives.step_exchanges``: each exchange's
   bytes, the same in every timed step); two runs
   from the seed bitwise equal; ``zone_shard`` on equal to off over 3
   steps (zone state and tallies, bitwise); 2 + 2 steps through a
   checkpoint with the walltime guard tripped on rank 1 only, bitwise
   equal to 4 steps (every rank's state, the tallies, both pNNN_evb.dat
   files); the flight kernel against its plain version, as in phase 2, on
   rank 0's first-round inputs of its first timed step; and 1 rank (this
   process) against 2 ranks, 6 seeds a side and 3 steps each:
   tools/pallas_e2e.py's test (``e2e_gate.z_test``: z < 4 or a deviation
   below 1%) on escaped, census, edep_total, scatter_gain and te_mean,
   each deviation logged beside its noise floor;
10. the gate against the reference's Pallas kernel at bench size
   (``e2e_gate``): for each cell of the committed
   ``compton2d_tpu_torch/data/gate_reference.json`` (``main_path``: the
   8x4 bench corona, B1 with shared tables; ``pair_corona``:
   tools/pallas_e2e.py's pair configuration, B2; ``pair_corona_strat``:
   the same with stratified splitting (gamma_c 10, p_max 0.5), B2 with
   B3; ``grid_40x30``: the windowed-test grid at 131072 slots, B4), the
   port's configuration
   equal to the recorded one field for field, 12 seeds of the recorded
   statistic (the last of S steps with the census roulette kept, in
   every cell since its floors came in at or below 5%) on the card,
   and ``e2e_gate.gate`` against the reference's 12 replicates
   (tools/pallas_e2e.run_gate's test: the scalar channels, the escaping
   spectrum against its split-half floor, the zone temperatures); every
   channel's deviation, noise floor and z logged; the cell's mode only,
   and no plain-version run;
11. the repository's two root entry points as ported:
   ``python -m compton2d_tpu_torch.bench`` in a process of its own at its
   default size (the main path's 2 warm-up and 16 timed steps, Mrk 421,
   and the ``pair_corona`` and ``pair_corona_strat`` gates), its last
   line one record with bench.py's keys, a positive rate, B1 launches on
   its main path and both gate records passed and equal to phase 10's
   (the same seeds give the same replicates); then
   ``dryrun.dryrun_multichip(2)``: the main path's widths with pairs and
   the Coulomb terms on 2 gloo ranks sharing cuda:0 (32768 slots a rank,
   an event buffer of 64 records, the census roulette's thresholds at
   0.05 and 0.03) against one rank of the same global photon count (the
   first step's budget to rtol 1e-6, the roulette fired, every audit
   within 5e-3, the census within 0.5x-2x, one event count a rank with
   its dropped records counted), and the 1-vs-2-rank z-test over 5 seeds
   a side at the tiny shapes (z < 4), with pair-mode launches only;
12. the lock-step flight loop (``pallas_tracking`` "off", grids with an
   edge above 127, slot counts off the 1024 tile): (a) the main path on
   the loop and on the kernel in turns, 2 warm-up and 4 timed steps each:
   every step's audit within 2e-3 (phase 3's bound; both trackers read
   |balance - 1| up to 2.1e-4 here), its tracking iterations (rounds on the
   kernel), stragglers and ms, the loop with no kernel launch and the
   kernel with B1 launches only, and each tracker's ms/step and
   transport_step ms/step; (b) the ``tracker_main`` gate
   (``e2e_gate.tracker_gate``: ``tools/pallas_e2e.py``'s comparison of
   the kernel against the loop on ``main_path``, 12 seeds a side, the last
   of 4 steps with the roulette kept, z < 4), which must pass; (c)
   ``small_corona`` at 128x128 zones (nst 240000, 524288 slots, the main
   path's widths) under "auto": the loop, no zone sort, 1 warm-up and 2
   timed steps with their audit, iterations and stragglers, the card's
   peak memory and the step split into volume_em, fp_step and
   transport_step; and "on" refusing that grid (NotImplementedError); (d)
   the main path at 130000 slots under "auto": 2 steps on the loop with
   their audit.
13. the FP substep kernel (``csrc/fp_substeps.cu``, one launch a step)
   on both benchmark cells' configurations as the port builds them
   (``compare_fp.cell_sim``): the Mrk 421 dense run (phase 4's: 10x4
   zones, num_nt 200, nphfield 400) from t = 0, whose zones take from a
   few to some 150 substeps, and the 99x99 corona (large_corona) after
   its 4 set-up steps. The launch count, set to 0 before the cell's
   main-path steps (5 and 2), must equal their FP steps. On the last
   step's fp_step inputs the kernel against the plain substep loop
   (``compare_fp.compare``): per-zone substep counts and incomplete
   zones equal, tea and f_nt within 2e-6 (the benchmark check's gap
   measures); then the kernel on the device alone (CUDA events around
   20 launches) beside its bound (``roofline.fp_kernel_bound``: the
   zone-substeps it ran), fp_step with the kernel and with the plain
   loop (CUDA events around each call, medians of FP_TURNS in turns)
   beside fp_step's bound (``roofline.fp_bound``: the benchmark's
   ``fp_roofline_pct`` model), and ptxas's registers and shared memory.
   Phase 2's main path also counts one FP kernel launch a step.
14. the synchrotron sums kernel (``csrc/volume_em.cu``, one launch a
   step) on the configurations of the benchmark's one-card cells as its
   harness builds them (``compare_volume_em.cell_sim``): the Mrk 421
   dense run from t = 0 (10x4 zones, 5 steps), corona99 after its 4
   set-up steps (99x99, 1 step) and the pair corona after its 4 (4x3, 1
   step). The launch count, set to 0 before the cell's main-path steps,
   must equal them. On the last step's inputs: each of corona99.ranks4's
   four 2451-zone slices (``zone_slice``'s, the last zone repeated into
   the pad) bit for bit the whole grid's rows; the kernel against the
   plain version (``compare_volume_em.compare``: both sums within what
   the order of 200 float32 terms allows, 2 x 199 units of the last
   place of the terms' magnitudes) on each cell and on rank 0's slice;
   then the kernel on the device alone (CUDA events around 20 launches)
   beside its bound (``roofline.volume_em_bound``, the benchmark's
   ``volume_em_roofline_pct`` model), the plain version's time (medians
   of VE_TURNS) and the share of terms it skips (t >= 1e4, or exp(-2 ts)
   underflowing). Phase 3's
   main path also counts one launch a step, and phase 9's ranks one a
   zone_shard step each.

From phase 2 to phase 11 every Simulation built in this process (and in
phase 9's ranks) and every step it takes must select the flight kernel
(``kernel_only``), and the bench's record and the dry run name the
kernel as their tracker: no earlier path drifts onto the loop.

The first five phases' launches of the path-shaped modes read their
tables from shared memory (checked with the wrapper's count of
global-table launches), the windowed and 32x32 ones from global memory;
in phase 7 the disk deck's and in phase 8 the Coulomb corona's from
shared memory (counted in the 8x4 entry of the kernels line) and the
blazar blob's (10x5 zones, 252,064 bytes) from global memory, in an
entry of their own, timed on that deck's inputs. Phase 9's launches (the
same mode and tables on each rank's half of the slots) count in the 8x4
entry too, as phase 10's main_path launches do; phase 10's pair_corona
launches count in the pair entry, its pair_corona_strat launches in
the strat pair entry and its grid_40x30 launches in the windowed entry;
phase 11's dry-run launches (pair mode, in the ranks and in this
process) count in the pair entry; phase 12's kernel-side main path and
its tracker_main gate count in the 8x4 entry. The loop is no kernel: it
runs as PyTorch operations. The bench's launches are its own process's,
read from its record and not counted in the line.

Each kernel's wrapper counts its launches; the counts are set to 0 just
before each main path and read just after. The line before the last is a
JSON summary of every kernel mode with its times and its roofline bound
(``ms`` is the wrapper-included call, as in every earlier version of this
line; ``device_ms`` the kernel alone);
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Tuple

import numpy as np
import torch

from compton2d_tpu_torch import (bench, collectives, compare_fp,
                                 compare_volume_em, decks, driver, dryrun,
                                 e2e_gate, kernel_build, obs_compare,
                                 roofline, run_mrk421)
from compton2d_tpu_torch.config import RunConfig
from compton2d_tpu_torch.constants import SIGMA_THOMSON
from compton2d_tpu_torch.examples import corona_config, small_corona
from compton2d_tpu_torch.fp import update
from compton2d_tpu_torch.io import checkpoint, native
from compton2d_tpu_torch.parallel import distributed
from compton2d_tpu_torch.physics import coulomb
from compton2d_tpu_torch.physics import emissivity
from compton2d_tpu_torch.state import PhotonArray
from compton2d_tpu_torch.physics.electron_dist import gnt_grid
from compton2d_tpu_torch.tables import e_field_grid, e_gg_grid
from compton2d_tpu_torch.transport import flight, population, tracking

N_SLOTS, NZ, NR, N_VOL, NUM_NT = 1 << 17, 8, 4, 400, 200
MRK_NZ, MRK_NR = 10, 4       # the Mrk 421 grid
# the pair corona (tools/pallas_e2e.py's pair configuration)
PAIR_SLOTS, PAIR_NZ, PAIR_NR, PAIR_VOL, PAIR_NT, PAIR_GG = (
    1 << 18, 4, 3, 128, 100, 32)
PAIR_TIMED, PAIR_STRAT_STEPS = 6, 3
PAIR_AUDIT_TOL = 5e-3   # tools/pallas_e2e.py's audit bound
# a strat pair step of more rounds than this must start optically thick
STRAT_THICK_ROUNDS, THICK_TAU = 50, 10.0
TIMED_STEPS, WARM_STEPS = 8, 2
# the large grid (large_corona) and the reference's windowed-test grid
LARGE_NZ, LARGE_NR, LARGE_SLOTS, LARGE_NST = 99, 99, 1 << 19, 240000
GRID_NZ, GRID_NR = 40, 30
RESIDENT_NZ, RESIDENT_NR = 32, 32   # the largest resident grid
LARGE_TIMED, LARGE_WARM, GRID_STEPS = 3, 1, 2
# the reference-format decks (compton2d_tpu_torch.decks)
DECK_WARM, DECK_TIMED, DECK_REPEAT = 2, 6, 2
# the production run: the Coulomb corona's steps, the checkpoint's split
# and the pair corona's steps before its dumps
COUL_WARM, COUL_TIMED = 2, 6
CKPT_FIRST, CKPT_RESUMED = 3, 3
PAIR_DUMP_STEPS = 2
FP_TURNS = 6          # fp_step with and without the Coulomb terms
AUDIT_TOL = 2e-3     # |balance - 1|, the JAX tests' bound
MRK_AUDIT_TOL = 5e-3  # the bound of tests/test_mrk421.py
MAX_TRIES = RunConfig().max_scatter_tries
# the pair mode's one-iteration check: the share of lanes that may exceed
# rtol 1e-5, each within 10x its own sensitivity (lane_sensitivity)
MAX_OVER = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain version
# ---------------------------------------------------------------------------
def kernel_inputs(device, nz: int = NZ, nr: int = NR, seed: int = 0,
                  n: int = N_SLOTS, n_vol: int = N_VOL, num_nt: int = NUM_NT,
                  n_gg: int = 0):
    """Random photons and zone tables at a main path's shapes. With
    ``n_gg``, a gamma-gamma opacity table of order 1 per unit length (the
    domain's size) on the e_gg grid, and photon energies from 1 keV to 5
    MeV: below 47 keV, below the grid's 50 keV, on it and above it."""
    rng = np.random.default_rng(seed)
    nzr = nz * nr
    e_ph = e_field_grid(n_vol).astype(np.float32)
    gnt = gnt_grid(num_nt).astype(np.float32)
    # scattering opacity of a few per unit length with a KN-like cutoff,
    # weak absorption rising toward low energies
    sig = rng.uniform(1.0, 10.0, (nzr, 1)) / (1.0 + e_ph[None, :] / 511.0)
    kap = rng.uniform(0.0, 0.05, (nzr, 1)) * np.minimum(
        1.0, (e_ph[None, :] / 1e-3) ** -1.5)
    theta = rng.uniform(0.05, 0.4, (nzr, 1))
    g = gnt[None, :] + 1.0
    pdf = g * g * np.sqrt(1.0 - 1.0 / (g * g)) * np.exp(-gnt[None, :] / theta)
    cdf = np.concatenate(
        [np.zeros((nzr, 1)), np.cumsum(pdf[:, :-1] * np.diff(gnt), axis=1)],
        axis=1)
    cdf = (cdf / cdf[:, -1:]).astype(np.float32)
    r_edges = np.linspace(0.0, 1.0, nr + 1).astype(np.float32)
    z_edges = np.linspace(0.0, 1.0, nz + 1).astype(np.float32)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    kgg, e_gg_log0, e_gg_dlog = None, 0.0, 1.0
    if n_gg:
        e_gg = e_gg_grid(n_gg).astype(np.float32)
        kgg = t(rng.uniform(0.5, 3.0, (nzr, 1))
                * np.linspace(0.1, 1.0, n_gg)[None, :])
        e_gg_log0 = float(np.log(e_gg[0]))
        e_gg_dlog = float(np.log(e_gg[1] / e_gg[0]))
    tables = flight.build_flight_tables(
        t(np.stack([sig, kap], axis=-1)), t(cdf), t(gnt), t(r_edges),
        t(z_edges), float(np.log(e_ph[0])), float(np.log(e_ph[1] / e_ph[0])),
        kgg_zone=kgg, e_gg_log0=e_gg_log0, e_gg_dlog=e_gg_dlog,
    )
    jz = rng.integers(0, nz, n)
    kr = rng.integers(0, nr, n)
    r = r_edges[kr] + rng.uniform(0.01, 0.99, n) * (1.0 / nr)
    z = z_edges[jz] + rng.uniform(0.01, 0.99, n) * (1.0 / nz)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    w = rng.uniform(0.5, 1.5, n)
    log_e = rng.uniform(0.0, 3.7, n) if n_gg else rng.uniform(-3.0, 2.0, n)
    photons = dict(
        e=t(10.0 ** log_e), w=t(w), w0=t(w), r=t(r),
        z=t(z), mu=t(rng.uniform(-1.0, 1.0, n)), cphi=t(np.cos(phi)),
        sphi=t(np.sin(phi)), dcen=t(rng.uniform(0.01, 0.5, n)),
        jz=t(jz, torch.int32), kr=t(kr, torch.int32),
        alive=t(rng.uniform(size=n) < 0.9, torch.bool),
    )
    seeds = t(rng.integers(-2**31, 2**31, n // flight.TILE), torch.int32)
    return photons, tables, seeds


INT_FIELDS = ("jz", "kr", "alive", "mode", "flag", "jn", "kn", "sct_cnt")
LANE_FLOATS = ("e", "w", "r", "z", "mu", "cphi", "sphi", "dcen")


def run_flight(fn, photons, tables, seeds, max_iters, nz=NZ, nr=NR,
               inline=True, pairs=False, weight_floor=1e-10,
               max_tries=MAX_TRIES):
    p = photons
    return fn(p["e"], p["w"], p["w0"], p["r"], p["z"], p["mu"], p["cphi"],
              p["sphi"], p["dcen"], p["jz"], p["kr"], p["alive"], tables,
              seeds, nz=nz, nr=nr, weight_floor=weight_floor,
              max_iters=max_iters, max_tries=max_tries,
              inline_scatter=inline, pair_switch=pairs)


def outputs_equal(a, b) -> bool:
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            if not torch.equal(x, y):
                return False
        elif x != y:
            return False
    return True


def assert_sums_close(k, p, tol: float, e_scale: float, label: str,
                      w_zone=None):
    """Tallies and energy sums of kernel ``k`` against plain ``p``. The two
    add in different orders, so each is held to ``tol`` of its natural
    scale: the input energy for the energy sums, each zone's edep for
    edep, and c x edep for prdep, a signed sum of terms up to
    c x (absorbed energy) that cancels to a much smaller net value. With
    ``w_zone`` (grids of MAX_ZONES zones or more only), each zone's sum of
    the weights that deposit in it, edep and prdep may also differ by
    2^-22 of that weight (c x that for prdep): a deposit w - w exp(-x)
    inherits a last-bit difference of exp(-x) at w's own scale, which a
    weakly absorbing zone's small net deposit cannot hide."""
    ed_k, ed_p = k.tally[0], p.tally[0]
    c_light = float(np.float32(2.9979245620e10))
    if w_zone is None:
        torch.testing.assert_close(
            ed_k, ed_p, rtol=tol,
            atol=tol * float(torch.max(torch.abs(ed_p))),
            msg=lambda m: f"{label} edep: {m}")
    else:
        err = torch.abs(ed_k - ed_p)
        strict = (tol * torch.abs(ed_p)
                  + tol * float(torch.max(torch.abs(ed_p))))
        bound = strict + 2.0 ** -22 * w_zone
        over = err > strict
        if bool(torch.any(over)):
            i = int(torch.argmax(err - strict))
            log(f"{label} edep: {int(over.sum())} zones over the rtol bound, "
                f"the largest zone {i}: error {float(err[i]):.6e} against "
                f"{float(strict[i]):.6e}, edep {float(ed_p[i]):.6e}, "
                f"depositing weight {float(w_zone[i]):.6f}")
        if bool(torch.any(err > bound)):
            i = int(torch.argmax(err - bound))
            raise AssertionError(f"{label} edep: zone {i} error "
                                 f"{float(err[i])} over bound "
                                 f"{float(bound[i])}")
    err = torch.abs(k.tally[1] - p.tally[1])
    bound = tol * (c_light * torch.abs(ed_p) + torch.abs(p.tally[1]))
    if w_zone is not None:
        bound = bound + c_light * 2.0 ** -22 * w_zone
    if bool(torch.any(err > bound)):
        raise AssertionError(f"{label} prdep: max error {float(err.max())}"
                             f" over bound {float(bound.min())}")
    for f in ("ekill", "esct", "epair"):
        torch.testing.assert_close(getattr(k, f), getattr(p, f), rtol=tol,
                                   atol=tol * e_scale,
                                   msg=lambda m, f=f: f"{label} {f}: {m}")


def lane_sensitivity(photons, tables, seeds, p, kw) -> dict:
    """Each lane's conditioning: how far the plain version's one-iteration
    result ``p`` moves when every float input moves by 2 ulp, up or down
    at random, in four draws (the largest move per lane and field). A
    flight that ends next to the axis, where cphi = (f_h + cphi r) /
    r_new, or a collision length read on a coarse opacity grid, where a
    last-bit change of log(e) moves the interpolation weight, amplifies
    last-bit differences."""
    rng = np.random.default_rng(1)
    n = photons["e"].shape[0]
    sens = {f: torch.zeros_like(getattr(p, f)) for f in LANE_FLOATS}
    for _ in range(4):
        moved = dict(photons)
        for f in LANE_FLOATS + ("w0",):
            sign = torch.as_tensor(rng.choice([-1.0, 1.0], n),
                                   dtype=torch.float32,
                                   device=photons[f].device)
            moved[f] = photons[f] * (1.0 + sign * 2.0 ** -22)
        p_eps = run_flight(flight.flight_step_reference, moved, tables,
                           seeds, 1, **kw)
        for f in LANE_FLOATS:
            sens[f] = torch.maximum(
                sens[f], torch.abs(getattr(p_eps, f) - getattr(p, f)))
    return sens


def simt_efficiency(counters) -> float:
    """Lane-iterations over 32 x the warp passes through the state
    bodies, from the kernel's per-warp counters."""
    c = counters.sum(dim=0, dtype=torch.int64).tolist()
    return c[0] / (32.0 * (c[1] + c[2] + c[3]))


def block_plan(tables, nz: int, nr: int, inline: bool, pairs: bool):
    """The kernel's block plan for these inputs on card 0."""
    return flight.plan_block(nz, nr, tables.sig.shape[1],
                             tables.kgg.shape[1], tables.cdf.shape[1],
                             inline, pairs)


def path_inputs(device, nz: int, nr: int, **shapes):
    """kernel_inputs as the path hands them over: above 1024 zones the
    census zone-sorted, then its free tail refilled out of zone order, as
    emission refills it on the path with boundary photons spread over the
    grid (those tiles freeze lanes at once)."""
    photons, tables, seeds = kernel_inputs(device, nz, nr, **shapes)
    win_z = flight.window_z(nz, nr)
    if win_z:
        photons = population.zone_sort(
            PhotonArray(*(photons[f] for f in PhotonArray._fields)), nz, nr,
            win_z)._asdict()
        photons["alive"] = torch.ones_like(photons["alive"])
    return photons, tables, seeds


def phase_kernel(device, label: str, nz: int, nr: int, inline: bool,
                 max_iters: int, pairs: bool = False,
                 placement: str = "shared", **shapes) -> dict:
    """One kernel mode against its plain version at (nz, nr) zones; with
    ``pairs``, the pair mode at the ``shapes`` of kernel_inputs; above
    1024 zones, the windowed mode on inputs zone-sorted as on the path.
    The tables must take ``placement``."""
    photons, tables, seeds = path_inputs(device, nz, nr, **shapes)
    return check_kernel(device, label, photons, tables, seeds, max_iters,
                        dict(nz=nz, nr=nr, inline=inline, pairs=pairs),
                        placement)


def check_kernel(device, label: str, photons, tables, seeds, max_iters: int,
                 kw: dict, placement: str) -> dict:
    """The kernel against its plain version on these inputs, with
    run_flight's keywords ``kw``: (a) one iteration, (b) ``max_iters``,
    (c) two launches bitwise equal, (d) times and the bound."""
    nz, nr, inline, pairs = kw["nz"], kw["nr"], kw["inline"], kw["pairs"]
    n = photons["e"].shape[0]
    plan = block_plan(tables, nz, nr, inline, pairs)
    staged = flight.table_placement(
        nz, nr, tables.sig.shape[1], tables.kgg.shape[1],
        tables.cdf.shape[1], inline, pairs)
    if staged[0] != placement or plan.shared != (placement == "shared"):
        raise AssertionError(f"{label}: tables {staged}, expected "
                             f"{placement}")
    log(f"{label}: tables in {staged[0]} memory ({staged[1]} bytes read "
        f"by the mode), {plan.per_sm} blocks of {plan.threads} threads per "
        f"SM, {n // plan.threads} blocks, {plan.smem} bytes of shared "
        f"memory")
    win_z = flight.window_z(nz, nr)
    e_scale = float(torch.sum(photons["w"]))   # total input energy

    # (a) one iteration: integers exact, floats rtol 1e-5 (atol 1e-6 for
    # values near zero); tallies and sums to 1e-5 of their scale
    # (assert_sums_close)
    k = run_flight(flight.flight_step, photons, tables, seeds, 1, **kw)
    p = run_flight(flight.flight_step_reference, photons, tables, seeds, 1,
                   **kw)
    torch.cuda.synchronize()
    logs = ("iglog", "delog") if inline else ()
    for f in INT_FIELDS + logs[:1]:
        if not torch.equal(getattr(k, f).to(torch.int64),
                           getattr(p, f).to(torch.int64)):
            bad = int((getattr(k, f) != getattr(p, f)).sum())
            raise AssertionError(f"{label} (a) {f}: {bad} lanes differ")
    if k.it_used != p.it_used:
        raise AssertionError(f"{label} (a) it_used {k.it_used} != "
                             f"{p.it_used}")
    # floats rtol 1e-5 (atol 1e-6 near zero), as assert_close. In the
    # pair mode at most 1e-4 of the lanes may exceed that, each by less
    # than 10x its own sensitivity (lane_sensitivity)
    sens = lane_sensitivity(photons, tables, seeds, p, kw) if pairs else {}
    max_abs, n_over = 0.0, 0
    for f in LANE_FLOATS + logs[1:]:
        a, b = getattr(k, f), getattr(p, f)
        err = torch.abs(a - b)
        if f not in sens:
            torch.testing.assert_close(
                a, b, rtol=1e-5, atol=1e-6,
                msg=lambda m, f=f: f"{label} (a) {f}: {m}")
        else:
            tol = 1e-6 + 1e-5 * torch.abs(b)
            over = err > tol
            n_f = int(over.sum())
            wide = over & (err > tol + 10.0 * sens[f])
            if n_f > MAX_OVER * n or bool(torch.any(wide)):
                raise AssertionError(
                    f"{label} (a) {f}: {n_f} lanes over rtol 1e-5 (at most "
                    f"{MAX_OVER * n:.1f}), {int(wide.sum())} of them over "
                    f"10x their sensitivity, max {float(err.max()):.3e}")
            n_over = max(n_over, n_f)
        max_abs = max(max_abs, float(torch.max(err)))
    # grids of MAX_ZONES zones or more (the 32x32 resident grid, the
    # windowed mode's 99x99): each zone's depositing weight (in one
    # iteration each live lane deposits in its own zone only). With about
    # 128 lanes a zone, a 2-ulp difference of one lane's exp(-x) shows in
    # a zone's small net deposit (assert_sums_close logs the zones that
    # need the allowance)
    w_zone = None
    if nz * nr >= flight.MAX_ZONES:
        live = photons["alive"] & (photons["dcen"] > 0.0)
        zid = (torch.clamp(photons["jz"], 0, nz - 1) * nr
               + torch.clamp(photons["kr"], 0, nr - 1))
        w_zone = torch.zeros(nz * nr, device=device).index_add_(
            0, zid.long(), torch.where(live, photons["w"], 0.0))
    assert_sums_close(k, p, 1e-5, e_scale, f"{label} (a)", w_zone)
    n_sct = int((k.flag == flight.FLAG_SCATTER).sum())
    if not inline and n_sct == 0:
        raise AssertionError(f"{label} (a) no lane froze with FLAG_SCATTER")
    n_win = int((k.flag == flight.FLAG_WINDOW).sum())
    if win_z and n_win == 0:
        raise AssertionError(f"{label} (a) no lane froze with FLAG_WINDOW")
    if pairs and not float(p.epair) > 1e-3 * e_scale:
        raise AssertionError(f"{label} (a) epair {float(p.epair)} too small")
    log(f"{label} (a) max_iters=1: integers exact ({n_sct} FLAG_SCATTER, "
        f"{n_win} FLAG_WINDOW lanes), max |float diff| = {max_abs:.3e} "
        f"(lanes over rtol 1e-5: {n_over}), epair kernel "
        f"{float(k.epair):.6e} plain {float(p.epair):.6e}")

    # (b) the path's budget: >= 99% of lanes with identical integer
    # state; tallies and sums to 1e-3 of their scale
    k = run_flight(flight.flight_step, photons, tables, seeds, max_iters,
                   **kw)
    p = run_flight(flight.flight_step_reference, photons, tables, seeds,
                   max_iters, **kw)
    torch.cuda.synchronize()
    same = torch.ones(n, dtype=torch.bool, device=device)
    for f in INT_FIELDS:
        same &= getattr(k, f).to(torch.int64) == getattr(p, f).to(torch.int64)
    frac = float(same.float().mean())
    if frac < 0.99:
        raise AssertionError(f"{label} (b) identical lanes {frac:.5f} < 0.99")
    assert_sums_close(k, p, 1e-3, e_scale, f"{label} (b)")
    log(f"{label} (b) max_iters={max_iters}: identical lanes {frac:.6f}, "
        f"it_used kernel {k.it_used} plain {p.it_used}, scatters/lane "
        f"{float(k.sct_cnt.float().mean()):.3f}, FLAG_SCATTER lanes "
        f"{int((k.flag == flight.FLAG_SCATTER).sum())}, FLAG_WINDOW lanes "
        f"{int((k.flag == flight.FLAG_WINDOW).sum())}, epair/input "
        f"{float(k.epair) / e_scale:.6f}")

    # (c) repeatability: a second launch is bitwise equal
    k2 = run_flight(flight.flight_step, photons, tables, seeds, max_iters,
                    **kw)
    torch.cuda.synchronize()
    if not outputs_equal(k, k2):
        raise AssertionError(f"{label} (c) two kernel launches differ")
    log(f"{label} (c) two launches bitwise equal")

    # (d) times at the path's budget: the kernel on the device alone
    # (events_ms), and medians after a warm-up of calls synchronised each
    # (the wrapper included: the ``ms`` of every earlier version)
    def timed(fn, reps):
        run_flight(fn, photons, tables, seeds, max_iters, **kw)
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_flight(fn, photons, tables, seeds, max_iters, **kw)
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(ts)

    plain_ms = timed(flight.flight_step_reference, 3)
    wrapped_ms = timed(flight.flight_step, 20)
    launch = run_flight(flight.launch_only, photons, tables, seeds, max_iters,
                        **kw)
    device_ms = events_ms(launch)
    bound = roofline.flight_bound(photons, tables, k, nz, nr, pairs)
    log(f"{label} (d) kernel {device_ms:.4f} ms on the device alone, "
        f"{wrapped_ms:.4f} ms with the wrapper, plain torch "
        f"{plain_ms:.4f} ms ({n} slots, {nz}x{nr} zones, max_iters="
        f"{max_iters}); bound {bound['bound_ms']:.6f} ms by "
        f"{bound['bound_by']} ({bound['bytes']} bytes, {bound['ops']} "
        f"operations); SIMT efficiency {simt_efficiency(k.counters):.4f} "
        f"(lane-iterations {int(k.counters[:, 0].sum())})")
    return {"max_abs_err": max_abs, "ms": wrapped_ms,
            "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}


DEVICE_REPS = 20


def events_ms(launch) -> float:
    """The kernel's own time: CUDA events around DEVICE_REPS launches on
    preallocated outputs (a ``launch_only`` hook), after one warm-up
    launch, per launch."""
    launch()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(DEVICE_REPS):
        launch()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / DEVICE_REPS


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------
def state_devices(state) -> set:
    devs = set()

    def walk(obj):
        if isinstance(obj, torch.Tensor):
            devs.add(obj.device.type)
        elif isinstance(obj, torch.Generator):
            devs.add(obj.device.type)
        elif hasattr(obj, "_fields"):
            for name in obj._fields:
                walk(getattr(obj, name))

    walk(state)
    return devs


def bench_sim(device, seed: int = 0, nz: int = NZ, nr: int = NR,
              nst: int = 60000, n_slots: int = N_SLOTS, **phys_kw):
    """The main path's corona; with other (nz, nr, nst, n_slots) the
    large grid's coronae at the main path's widths; ``phys_kw`` sets
    options of its PhysicsConfig."""
    return small_corona(nz=nz, nr=nr, nst=nst, n_slots=n_slots,
                        num_nt=NUM_NT, n_vol=N_VOL, nphfield=400,
                        t_const=False, max_flight_iters=256, seed=seed,
                        device=device, **phys_kw)


def small_audit(device, seed: int):
    sim = small_corona(nz=3, nr=2, nst=3000, n_slots=4096, num_nt=50,
                       n_vol=64, nphfield=64, t_const=False, seed=seed,
                       device=device)
    sim.run(2)
    return sim.energy_audit()


def phase_main_path(device, card: str) -> int:
    sim = bench_sim(device)
    outs = []
    flight.reset_launch_counts()
    update.reset_launch_counts()
    emissivity.reset_launch_counts()
    for _ in range(WARM_STEPS):
        outs.append(sim.step())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        outs.append(sim.step())
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = flight.LAUNCHES
    if launches <= 0:
        raise AssertionError("the main path launched no flight kernel")
    fp_launches = update.launch_counts()["fp_substeps"]
    log(f"main path: {fp_launches} FP substep kernel launches in "
        f"{len(outs)} steps")
    if fp_launches != len(outs):
        raise AssertionError("the main path's FP steps did not each launch "
                             "the FP substep kernel once")
    ve_launches = emissivity.launch_counts()["volume_em"]
    log(f"main path: {ve_launches} volume_em kernel launches in "
        f"{len(outs)} steps")
    if ve_launches != len(outs):
        raise AssertionError("the main path's zone passes did not each "
                             "launch the volume_em kernel once")
    if (flight.STRAT_LAUNCHES or flight.PAIR_LAUNCHES or flight.WINDOW_LAUNCHES
            or flight.GLOBAL_LAUNCHES):
        raise AssertionError("small_corona launched the strat, pair or "
                             "windowed mode, or read global tables")
    log(f"main path: {launches} flight kernel launches in "
        f"{WARM_STEPS + TIMED_STEPS} steps")

    devs = state_devices(sim.state)
    if devs != {"cuda"}:
        raise AssertionError(f"state tensors on {devs}, expected cuda only")
    for i, out in enumerate(outs):
        sim.last_outputs = out
        a = sim.energy_audit()
        if not abs(a["balance"] - 1.0) < AUDIT_TOL:
            raise AssertionError(f"step {i}: audit balance {a['balance']}")
        log(f"step {i}: balance {a['balance']:.7f} escaped "
            f"{a['escaped']:.4e} erg census {a['census']:.4e} erg "
            f"fp_incomplete {int(out.fp_incomplete)} rounds "
            f"{int(out.tallies.trk_rounds)} sct_overflow "
            f"{int(out.tallies.n_sct_overflow)}")
        if not a["escaped"] > 0.0:
            raise AssertionError(f"step {i}: nothing escaped")
    tea = sim.state.zones.tea
    if not bool(torch.all(torch.isfinite(tea))):
        raise AssertionError("non-finite zone temperatures")
    log(f"zone Te [keV]: min {float(tea.min()):.3f} max "
        f"{float(tea.max()):.3f}; {sim.summary()}")

    timed = outs[WARM_STEPS:]
    histories = sum(int(o.n_tracked) for o in timed)
    rounds = sum(int(o.tallies.trk_rounds) for o in timed) / TIMED_STEPS
    ms_step = 1e3 * elapsed / TIMED_STEPS
    log(f"main path on {card}: {ms_step:.3f} ms/step, "
        f"{histories / elapsed:.6e} histories/s, {rounds:.2f} tracking "
        f"rounds/step ({TIMED_STEPS} timed steps after {WARM_STEPS} warm-up)")
    # the roofline reading: the tracking phase's rounds at the byte model
    log(f"main path roofline: {roofline.round_bytes(sim)} bytes a tracking "
        f"round (the kernel entry and the leak pass), "
        f"{rounds * roofline.round_bytes(sim):.6e} bytes/step, tracking "
        f"bound {roofline.tracking_bound_ms(sim, rounds):.6f} ms/step at "
        f"{roofline.PEAK_BYTES_S:.3e} B/s against {ms_step:.3f} ms/step")

    # repeatability: a second run from the same seed gives bitwise-equal
    # tallies
    sim2 = bench_sim(device)
    for i in range(3):
        o2 = sim2.step()
        for f in o2.tallies._fields:
            if not torch.equal(getattr(o2.tallies, f),
                               getattr(outs[i].tallies, f)):
                raise AssertionError(f"step {i}: tally {f} not repeatable")
    log("main path: tallies bitwise repeatable from the seed (3 steps)")

    # agreement with the plain path (CPU) on a small grid; nst=3000
    # seed-to-seed spread is ~30% on these totals, so this catches wiring
    # faults, as the reference's own kernel-vs-XLA driver test does
    a_gpu = small_audit(device, seed=6)
    a_cpu = small_audit("cpu", seed=6)
    for q in ("escaped", "census"):
        rel = abs(a_gpu[q] - a_cpu[q]) / max(abs(a_cpu[q]), 1e-300)
        log(f"small grid {q}: card {a_gpu[q]:.4e} plain {a_cpu[q]:.4e} "
            f"rel {rel:.3f}")
        if not rel < 0.6:
            raise AssertionError(f"small grid {q} differs by {rel:.3f}")
    for a in (a_gpu, a_cpu):
        if not abs(a["balance"] - 1.0) < AUDIT_TOL:
            raise AssertionError(f"small grid audit {a['balance']}")
    return launches


# ---------------------------------------------------------------------------
# phase 4: the Mrk 421 flare run
# ---------------------------------------------------------------------------
MRK_ARGS = ["--nst", "200000", "--n-slots", "131072", "--n-e", "2e6",
            "--strat-gamma-c", "3e4", "--strat-copies", "64"]
ARTIFACT = os.path.join("artifacts", "mrk421_dense", "summary.json")
ARTIFACT_SED = os.path.join("artifacts", "mrk421_dense", "sed.dat")
ARTIFACT_OBS = os.path.join("artifacts", "mrk421_dense", "obs_compare.json")
# the synchrotron hump's centre (run_mrk421.sync_centroid_kev) against the
# committed artifact's: within this factor. Eight CPU runs of port and
# reference at a quarter of nst (tests/compare_mrk421.py) spread over
# 0.80-1.40 of the artifact's centre, eight seeds of the port at full
# width on an H100 (compton2d_tpu_torch/mrk421_seeds.py) over 1.05-1.38
CENTROID_FACTOR = 1.5


def phase_mrk421(device, card: str) -> int:
    args = run_mrk421.parser().parse_args(
        MRK_ARGS + ["--device", str(device)])
    counts = {"frozen": 0, "copies": 0, "calls": 0}
    apply_scatter = tracking.apply_scatter

    def counted(ph, tl, sct, *rest):
        # frozen scatters in, placed copies out (slots that came alive)
        ph2, tl2 = apply_scatter(ph, tl, sct, *rest)
        counts["calls"] += 1
        counts["frozen"] += int(sct.sum())
        counts["copies"] += int(ph2.alive.sum()) - int(ph.alive.sum())
        return ph2, tl2

    with tempfile.TemporaryDirectory() as out_dir:
        args.out = out_dir
        sim = run_mrk421.make_sim(args)
        sim.attach_outputs(out_dir, event_file="evb.dat")
        outs, audits = [], []
        step = sim.step

        def audited_step():
            out = step()
            outs.append(out)
            audits.append(sim.energy_audit())
            return out

        sim.step = audited_step
        tracking.apply_scatter = counted
        flight.reset_launch_counts()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            done = sim.run_to_stop()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            tracking.apply_scatter = apply_scatter
        launches = flight.STRAT_LAUNCHES
        if not done:
            raise AssertionError("run_to_stop did not reach t_stop")
        if (launches <= 0 or flight.LAUNCHES or flight.PAIR_LAUNCHES
                or flight.WINDOW_LAUNCHES or flight.GLOBAL_LAUNCHES):
            raise AssertionError(f"strat launches {launches}, inline "
                                 f"launches {flight.LAUNCHES}, pair "
                                 f"launches {flight.PAIR_LAUNCHES}, windowed "
                                 f"launches {flight.WINDOW_LAUNCHES}, global-"
                                 f"table launches {flight.GLOBAL_LAUNCHES}")
        if counts["frozen"] <= 0 or counts["copies"] <= 0:
            raise AssertionError(f"scatter counts {counts}")
        devs = state_devices(sim.state)
        if devs != {"cuda"}:
            raise AssertionError(f"state tensors on {devs}, expected cuda")
        for i, (out, a) in enumerate(zip(outs, audits)):
            log(f"mrk421 step {i}: balance {a['balance']:.7f} escaped "
                f"{a['escaped']:.4e} erg rounds "
                f"{int(out.tallies.trk_rounds)} events "
                f"{int(out.events.count[0])}")
            if not abs(a["balance"] - 1.0) < MRK_AUDIT_TOL:
                raise AssertionError(f"mrk421 step {i}: audit balance "
                                     f"{a['balance']}")
        evb = os.path.join(out_dir, "evb.dat")
        events = np.loadtxt(evb).reshape(-1, 7)
        if events.shape[0] <= 10000:
            raise AssertionError(f"{events.shape[0]} event records")
        # the event file went through the native formatter, whose parse
        # reads it back as numpy does
        lib = native.library_path()
        if not lib.exists() or not np.array_equal(
                native.read_event_file(evb), events):
            raise AssertionError(f"native event library {lib.name}: built "
                                 f"{lib.exists()}, parse differs")
        log(f"mrk421 event file: {events.shape[0]} records written by the "
            f"native formatter ({lib.name}), {os.path.getsize(evb)} bytes, "
            "its native parse equal to np.loadtxt")
        for name in ("spectrum.dat", "photons.dat", "temp_profile.dat",
                     "lc_mu00.dat"):
            if not os.path.getsize(os.path.join(out_dir, name)):
                raise AssertionError(f"{name} is empty")
        peaks = run_mrk421.postprocess(events, sim.cfg.grid.r_max, out_dir)
        centre = run_mrk421.sync_centroid_kev(
            np.loadtxt(os.path.join(out_dir, "sed.dat")))
        obs = obs_compare.compare(os.path.join(out_dir, "sed.dat"),
                                  obs_compare.load_obs_overlay())

    sync, ssc = peaks["sync_peak_keV_obs"], peaks["ssc_peak_keV_obs"]
    if sync is None or not 0.05 < sync < 50.0:
        raise AssertionError(f"sync peak {sync} keV outside 0.05-50")
    if ssc is None or not ssc > 1e6:
        raise AssertionError(f"SSC peak {ssc} keV not above 1e6")
    if not peaks["tev_band_records_all_mu"] > 0:
        raise AssertionError("no TeV-band records")
    ref_centre = run_mrk421.sync_centroid_kev(np.loadtxt(ARTIFACT_SED))
    if not abs(np.log(centre / ref_centre)) < np.log(CENTROID_FACTOR):
        raise AssertionError(f"sync hump centre {centre:.4g} keV, artifact "
                             f"{ref_centre:.4g} keV")
    with open(ARTIFACT_OBS) as fh:
        ref_obs = json.load(fh)
    log(f"mrk421 against the observed points (obs_compare, the committed "
        f"overlay's {sum(len(v[0]) for v in obs_compare.load_obs_overlay().values())} "
        f"points): X-ray median log10(model/obs) "
        f"{obs['xray_log10_model_over_obs_median']:.6f} (artifact "
        f"{ref_obs['xray_log10_model_over_obs_median']:.6f}), s* log10 "
        f"{obs['global_renorm_log10']:.6f} (artifact "
        f"{ref_obs['global_renorm_log10']:.6f}), TeV residual after s* "
        f"{obs['tev_log10_residual_after_renorm']} (artifact "
        f"{ref_obs['tev_log10_residual_after_renorm']}), sync peak "
        f"{obs['model_sync_peak_keV_obs']} keV (artifact "
        f"{ref_obs['model_sync_peak_keV_obs']}), in the observed decade "
        f"{obs['sync_peak_in_obs_decade']}")
    if not obs["sync_peak_in_obs_decade"]:
        raise AssertionError(f"sync peak {obs['model_sync_peak_keV_obs']} "
                             "keV outside 1e-2-1e1 keV")
    steps = len(outs)
    histories = sum(int(o.n_tracked) for o in outs)
    rounds = sum(int(o.tallies.trk_rounds) for o in outs) / steps
    with open(ARTIFACT) as fh:
        ref = json.load(fh)
    log(f"mrk421 on {card}: {1e3 * wall / steps:.3f} ms/step, "
        f"{histories / wall:.6e} histories/s, {rounds:.2f} rounds/step, "
        f"wall {wall:.3f} s, {launches} strat-mode launches, "
        f"{counts['frozen']} frozen scatters, {counts['copies']} placed "
        f"copies in {counts['calls']} apply_scatter calls; port vs "
        f"committed artifact: steps {steps} vs {ref['steps']}, records "
        f"{events.shape[0]} vs {ref['n_event_records']}, balance "
        f"{audits[-1]['balance']:.7f} vs {ref['balance']:.7f}, sync peak "
        f"{sync:.4g} vs {ref['sync_peak_keV_obs']:.4g} keV, sync hump "
        f"centre {centre:.4g} vs {ref_centre:.4g} keV, SSC peak "
        f"{ssc:.4g} vs {ref['ssc_peak_keV_obs']:.4g} keV, TeV all-mu "
        f"records {peaks['tev_band_records_all_mu']} vs "
        f"{ref['tev_band_records_all_mu']}, >100 GeV all-mu records "
        f"{peaks['gev100_records_all_mu']} vs "
        f"{ref['gev100_records_all_mu']}")
    return launches


# ---------------------------------------------------------------------------
# phase 5: the pair corona
# ---------------------------------------------------------------------------
def pair_sim(device, seed: int = 0, strat: bool = False):
    """tools/pallas_e2e.py's pair configuration; ``strat`` adds its
    stratified variant (the tail boundary inside the gamma <= 20 tail)."""
    sim = small_corona(nz=PAIR_NZ, nr=PAIR_NR, nst=200000,
                       n_slots=PAIR_SLOTS, num_nt=PAIR_NT, n_vol=PAIR_VOL,
                       nphfield=128, t_const=False, seed=seed,
                       pair_switch=1, amxwl=0.5, gmin=3.0, gmax=20.0,
                       device=device)
    if strat:
        sim = sim.with_config(dataclasses.replace(
            sim.cfg, source=dataclasses.replace(
                sim.cfg.source, strat_split=True, strat_gamma_c=10.0,
                strat_p_max=0.5)))
    return sim


def audit_pair_steps(sim, outs, label: str) -> dict:
    """Every step: |balance - 1| < 5e-3, finite zone fields and pair
    fields, f_pair >= 0; the step's gamma-gamma absorbed energy, pair
    fields and pair fraction are logged, and their extremes returned."""
    seen = {"pair_abs": 0.0, "k_gg": 0.0, "dn_pp": 0.0, "f_pair": 0.0,
            "dn_pp_min_pos": float("inf")}
    for i, (out, state) in enumerate(outs):
        sim.last_outputs = out
        a = sim.energy_audit()
        if not abs(a["balance"] - 1.0) < PAIR_AUDIT_TOL:
            raise AssertionError(f"{label} step {i}: audit {a['balance']}")
        z = state.zones
        for name in z._fields:
            if not bool(torch.all(torch.isfinite(getattr(z, name)))):
                raise AssertionError(f"{label} step {i}: zones.{name} not "
                                     "finite")
        for name in ("k_gg", "dn_pp", "dne_pa", "dnp_pa"):
            if not bool(torch.all(torch.isfinite(getattr(state, name)))):
                raise AssertionError(f"{label} step {i}: {name} not finite")
        if bool(torch.any(z.f_pair < 0.0)):
            raise AssertionError(f"{label} step {i}: negative f_pair")
        dn_pp = state.dn_pp
        pos = dn_pp[dn_pp > 0.0]
        seen["pair_abs"] = max(seen["pair_abs"], a["pair_abs"])
        seen["k_gg"] = max(seen["k_gg"], float(state.k_gg.max()))
        seen["dn_pp"] = max(seen["dn_pp"], float(dn_pp.max()))
        seen["f_pair"] = max(seen["f_pair"], float(z.f_pair.max()))
        if pos.numel():
            seen["dn_pp_min_pos"] = min(seen["dn_pp_min_pos"],
                                        float(pos.min()))
        log(f"{label} step {i}: balance {a['balance']:.7f} pair_abs "
            f"{a['pair_abs']:.4e} erg escaped {a['escaped']:.4e} erg rounds "
            f"{int(out.tallies.trk_rounds)} max k_gg "
            f"{float(state.k_gg.max()):.4e} dn_pp range "
            f"[{float(pos.min()) if pos.numel() else 0.0:.4e}, "
            f"{float(dn_pp.max()):.4e}] cm^-3 s^-1 ({pos.numel()} > 0) "
            f"f_pair max {float(z.f_pair.max()):.4e} n_pos max "
            f"{float(z.n_pos.max()):.4e} Te [{float(z.tea.min()):.2f}, "
            f"{float(z.tea.max()):.2f}] keV")
    return seen


def drive_pairs(sim, steps: int):
    """(outputs, state) after each step, and the seconds of the steps."""
    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        outs.append((sim.step(), sim.state))
    torch.cuda.synchronize()
    return outs, time.perf_counter() - t0


def phase_pairs(device, card: str) -> Tuple[int, int]:
    plain_runs = [0]
    reference = flight.flight_step_reference

    def counted_reference(*a, **k):
        plain_runs[0] += 1
        return reference(*a, **k)

    flight.flight_step_reference = counted_reference
    try:
        sim = pair_sim(device)
        flight.reset_launch_counts()
        warm, _ = drive_pairs(sim, WARM_STEPS)
        timed, elapsed = drive_pairs(sim, PAIR_TIMED)
        launches = flight.PAIR_LAUNCHES
        if launches <= 0 or launches != flight.LAUNCHES:
            raise AssertionError(f"pair launches {launches}, inline "
                                 f"launches {flight.LAUNCHES}")
        if (flight.STRAT_LAUNCHES or flight.WINDOW_LAUNCHES
                or flight.GLOBAL_LAUNCHES or plain_runs[0]):
            raise AssertionError(f"strat launches {flight.STRAT_LAUNCHES}, "
                                 f"windowed launches {flight.WINDOW_LAUNCHES}"
                                 f", global-table launches "
                                 f"{flight.GLOBAL_LAUNCHES}, plain-version "
                                 f"runs {plain_runs[0]}")
        log(f"pair corona: {launches} pair-mode flight kernel launches in "
            f"{WARM_STEPS + PAIR_TIMED} steps, the plain version never ran")
        seen = audit_pair_steps(sim, warm + timed, "pair corona")
        if not seen["pair_abs"] > 0.0:
            raise AssertionError("no gamma-gamma absorbed energy")
        if not (seen["k_gg"] > 0.0 and seen["dn_pp"] > 0.0
                and seen["f_pair"] > 0.0):
            raise AssertionError(f"pair fields stayed zero: {seen}")
        if state_devices(sim.state) != {"cuda"}:
            raise AssertionError("pair corona state left the card")
        histories = sum(int(o.n_tracked) for o, _ in timed)
        rounds = sum(int(o.tallies.trk_rounds) for o, _ in timed)
        log(f"pair corona on {card}: {1e3 * elapsed / PAIR_TIMED:.3f} "
            f"ms/step, {histories / elapsed:.6e} histories/s, "
            f"{rounds / PAIR_TIMED:.2f} rounds/step ({PAIR_TIMED} timed "
            f"steps after {WARM_STEPS} "
            f"warm-up); dn_pp over all steps in [{seen['dn_pp_min_pos']:.4e},"
            f" {seen['dn_pp']:.4e}] cm^-3 s^-1, max f_pair "
            f"{seen['f_pair']:.4e}, max k_gg {seen['k_gg']:.4e} per unit "
            "length")

        # repeatability: a second run from the same seed
        sim2 = pair_sim(device)
        for i, (o1, _) in enumerate((warm + timed)[:3]):
            o2 = sim2.step()
            for f in o2.tallies._fields:
                if not torch.equal(getattr(o2.tallies, f),
                                   getattr(o1.tallies, f)):
                    raise AssertionError(f"pair step {i}: tally {f} not "
                                         "repeatable")
        log("pair corona: tallies bitwise repeatable from the seed "
            "(3 steps)")

        # the stratified variant: pair mode with collisions frozen
        launches_strat = phase_pairs_strat(device, card, plain_runs)
    finally:
        flight.flight_step_reference = reference
    return launches, launches_strat


def thomson_depth(sim, zones) -> float:
    """The largest Thomson depth of the ``zones`` across a zone's smaller
    side, the pairs counted as scatterers: sigma_T n_e (1 + 2 f_pair)
    min(dz, dr)."""
    g = sim.grid
    side = float(torch.minimum(g.dz, g.dr)) * float(sim.scales.L)
    return SIGMA_THOMSON * side * float(
        torch.max(zones.n_e * (1.0 + 2.0 * zones.f_pair)))


def phase_pairs_strat(device, card: str, plain_runs: list) -> int:
    """The stratified pair corona for PAIR_STRAT_STEPS steps: pair-mode
    strat launches only, the audit of every step, and each step's rounds
    and kernel iterations beside the largest Thomson depth of its zones.
    A collision ends a strat-mode launch, so a step takes about as many
    rounds as its photons scatter, up to the iteration cap: a step of
    more than STRAT_THICK_ROUNDS rounds must start with a zone thicker
    than THICK_TAU."""
    iters = []
    launch = flight.flight_step

    def counted_iters(*a, **k):
        res = launch(*a, **k)
        iters[-1] += int(res.it_used)
        return res

    flight.reset_launch_counts()
    sim = pair_sim(device, strat=True)
    cap = sim.cfg.run.max_flight_iters
    outs = []
    taus = [thomson_depth(sim, sim.state.zones)]
    flight.flight_step = counted_iters
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PAIR_STRAT_STEPS):
            iters.append(0)
            outs.append((sim.step(), sim.state))
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    finally:
        flight.flight_step = launch
    launches = flight.STRAT_LAUNCHES
    if not (launches > 0 and flight.PAIR_LAUNCHES == launches
            and flight.LAUNCHES == 0 and flight.WINDOW_LAUNCHES == 0
            and flight.GLOBAL_LAUNCHES == 0 and plain_runs[0] == 0):
        raise AssertionError(
            f"strat pair corona launches: strat {launches} pair "
            f"{flight.PAIR_LAUNCHES} inline {flight.LAUNCHES} global-table "
            f"{flight.GLOBAL_LAUNCHES} plain {plain_runs[0]}")
    audit_pair_steps(sim, outs, "strat pair corona")
    taus += [thomson_depth(sim, state.zones) for _, state in outs]
    for i, (out, _) in enumerate(outs):
        rounds = int(out.tallies.trk_rounds)
        log(f"strat pair corona step {i}: {rounds} rounds, {iters[i]} "
            f"kernel iterations (cap {cap}), largest zone Thomson depth "
            f"{taus[i]:.4e} at the step's start")
        if rounds > iters[i]:
            raise AssertionError(f"strat pair step {i}: a round without a "
                                 "kernel iteration")
        if rounds > STRAT_THICK_ROUNDS and not taus[i] > THICK_TAU:
            raise AssertionError(f"strat pair step {i}: {rounds} rounds in "
                                 f"zones of Thomson depth {taus[i]:.3e}")
    log(f"strat pair corona on {card}: {1e3 * elapsed / PAIR_STRAT_STEPS:.3f}"
        f" ms/step, {launches} pair-mode strat launches in "
        f"{PAIR_STRAT_STEPS} steps")
    return launches


# ---------------------------------------------------------------------------
# phase 6: the large grid
# ---------------------------------------------------------------------------
def drive_large(sim, warm: int, timed: int):
    """Outputs of warm + timed steps and the seconds of the timed ones."""
    outs = [sim.step() for _ in range(warm)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        outs.append(sim.step())
    torch.cuda.synchronize()
    return outs, time.perf_counter() - t0


def check_windowed_run(label: str, plain_runs: list) -> int:
    """Windowed launches only, and no plain-version run; returns their
    count."""
    launches = flight.WINDOW_LAUNCHES
    if not (launches > 0 and flight.LAUNCHES == launches
            and flight.GLOBAL_LAUNCHES == launches
            and flight.STRAT_LAUNCHES == 0 and flight.PAIR_LAUNCHES == 0
            and plain_runs[0] == 0):
        raise AssertionError(
            f"{label} launches: windowed {launches} inline {flight.LAUNCHES}"
            f" global-table {flight.GLOBAL_LAUNCHES} strat "
            f"{flight.STRAT_LAUNCHES} pair {flight.PAIR_LAUNCHES} plain "
            f"{plain_runs[0]}")
    return launches


def audit_large_steps(sim, outs, label: str) -> None:
    """Every step's audit within AUDIT_TOL and escapes above 0, each step's
    rounds, FLAG_WINDOW freezes and stragglers logged; then finite zone
    temperatures and every tensor of the state on the card."""
    for i, out in enumerate(outs):
        sim.last_outputs = out
        a = sim.energy_audit()
        t = out.tallies
        log(f"{label} step {i}: balance {a['balance']:.7f} escaped "
            f"{a['escaped']:.4e} erg census {a['census']:.4e} erg rounds "
            f"{int(t.trk_rounds)} FLAG_WINDOW freezes {int(t.n_window)} "
            f"stragglers {int(t.n_straggler)} tracked {int(out.n_tracked)} "
            f"fp_substeps {int(out.fp_substeps)} fp_incomplete "
            f"{int(out.fp_incomplete)}")
        if not abs(a["balance"] - 1.0) < AUDIT_TOL:
            raise AssertionError(f"{label} step {i}: audit {a['balance']}")
        if not a["escaped"] > 0.0:
            raise AssertionError(f"{label} step {i}: nothing escaped")
    tea = sim.state.zones.tea
    if not bool(torch.all(torch.isfinite(tea))):
        raise AssertionError(f"{label}: non-finite zone temperatures")
    if state_devices(sim.state) != {"cuda"}:
        raise AssertionError(f"{label}: state tensors left the card")
    log(f"{label} zone Te [keV]: min {float(tea.min()):.3f} max "
        f"{float(tea.max()):.3f}")


def per_step(outs, field: str) -> float:
    return sum(int(getattr(o.tallies, field)) for o in outs) / len(outs)


def phase_large(device, card: str) -> Tuple[int, int]:
    """large_corona for LARGE_WARM + LARGE_TIMED steps, then the 40x30 grid
    twice from the seed for GRID_STEPS steps, then the 32x32 grid (1024
    zones, the resident mode with its tables in global memory) for
    GRID_STEPS steps; returns large_corona's windowed launches and the
    32x32 grid's launches."""
    plain_runs = [0]
    reference = flight.flight_step_reference

    def counted_reference(*a, **k):
        plain_runs[0] += 1
        return reference(*a, **k)

    flight.flight_step_reference = counted_reference
    try:
        sim = bench_sim(device, nz=LARGE_NZ, nr=LARGE_NR, nst=LARGE_NST,
                        n_slots=LARGE_SLOTS)
        torch.cuda.reset_peak_memory_stats(device)
        flight.reset_launch_counts()
        outs, elapsed = drive_large(sim, LARGE_WARM, LARGE_TIMED)
        launches = check_windowed_run("large_corona", plain_runs)
        peak = torch.cuda.max_memory_allocated(device)
        audit_large_steps(sim, outs, "large_corona")
        timed = outs[LARGE_WARM:]
        histories = sum(int(o.n_tracked) for o in timed)
        log(f"large_corona on {card}: {1e3 * elapsed / LARGE_TIMED:.3f} "
            f"ms/step, {histories / elapsed:.6e} histories/s, "
            f"{per_step(timed, 'trk_rounds'):.2f} rounds/step, "
            f"{per_step(timed, 'n_window'):.1f} FLAG_WINDOW freezes/step, "
            f"{per_step(timed, 'n_straggler'):.1f} stragglers/step "
            f"({LARGE_TIMED} timed steps after {LARGE_WARM} warm-up, "
            f"{launches} windowed launches in all); peak memory "
            f"{peak} bytes")
        del sim, outs, timed

        # the reference's windowed-test grid (tests/test_flight_pallas2.py)
        # at the main path's widths and slots, twice from the seed
        flight.reset_launch_counts()
        sim = bench_sim(device, nz=GRID_NZ, nr=GRID_NR)
        outs, elapsed = drive_large(sim, 0, GRID_STEPS)
        check_windowed_run("grid 40x30", plain_runs)
        audit_large_steps(sim, outs, "grid 40x30")
        sim2 = bench_sim(device, nz=GRID_NZ, nr=GRID_NR)
        for i, o1 in enumerate(outs):
            o2 = sim2.step()
            for f in o2.tallies._fields:
                if not torch.equal(getattr(o2.tallies, f),
                                   getattr(o1.tallies, f)):
                    raise AssertionError(f"grid 40x30 step {i}: tally {f} "
                                         "not repeatable")
        histories = sum(int(o.n_tracked) for o in outs)
        log(f"grid 40x30 on {card}: {1e3 * elapsed / GRID_STEPS:.3f} "
            f"ms/step, {histories / elapsed:.6e} histories/s, "
            f"{per_step(outs, 'trk_rounds'):.2f} rounds/step, "
            f"{per_step(outs, 'n_window'):.1f} FLAG_WINDOW freezes/step, "
            f"{per_step(outs, 'n_straggler'):.1f} stragglers/step; "
            f"tallies bitwise repeatable from the seed ({GRID_STEPS} steps)")
        del sim, sim2, outs

        # the largest resident grid, whose tables are read from global
        # memory
        flight.reset_launch_counts()
        sim = bench_sim(device, nz=RESIDENT_NZ, nr=RESIDENT_NR)
        outs, elapsed = drive_large(sim, 0, GRID_STEPS)
        global_launches = flight.GLOBAL_LAUNCHES
        if not (global_launches > 0 and flight.LAUNCHES == global_launches
                and flight.WINDOW_LAUNCHES == 0 and plain_runs[0] == 0):
            raise AssertionError(
                f"grid 32x32 launches: global-table {global_launches} inline "
                f"{flight.LAUNCHES} windowed {flight.WINDOW_LAUNCHES} plain "
                f"{plain_runs[0]}")
        audit_large_steps(sim, outs, "grid 32x32")
        log(f"grid 32x32 on {card}: {1e3 * elapsed / GRID_STEPS:.3f} "
            f"ms/step, {per_step(outs, 'trk_rounds'):.2f} rounds/step, "
            f"{global_launches} resident launches with global tables")
    finally:
        flight.flight_step_reference = reference
    return launches, global_launches


# ---------------------------------------------------------------------------
# phase 7: the reference-format decks
# ---------------------------------------------------------------------------
def audit_share(sim) -> Tuple[dict, float]:
    """The last step's audit and its reflection share sum(ed_ref) E /
    avail: a reflected photon's weight before reflection is in erlk_lower
    and its weight after it flies on, so the audit, as the reference's,
    counts ed_ref twice."""
    a = sim.energy_audit()
    avail = a["input"] - a["src_lost"] + a["scatter_gain"] - a["rr"]
    ed_ref = float(sim.last_outputs.tallies.ed_ref.sum())
    return a, ed_ref * sim.scales.E / avail


def drive_deck(sim, steps: int, record: list):
    """Step the sim; per step, the SourceStatic it used, the dt it took
    (the host mirror, read back under adaptive dt) and the zone
    temperatures it left, into ``record``."""
    outs = []
    for _ in range(steps):
        dt = sim._host_dt if not sim._clock_dirty else float(sim.state.dt)
        outs.append(sim.step())
        record.append((sim.src_static, dt, sim.state.zones.tea))
    return outs


def check_disk_step(name, i, out, sim, a, share, dt_used, dt_next, dt0,
                    dt_min, dt_new) -> str:
    """The disk deck's gates of step ``i``. Adaptive dt: the step after
    ncycle 0 keeps dt0; from ncycle 1 the next dt is the larger of the FP
    ladder's dt_new of this step (read from the run) and dt_min."""
    t = out.tallies
    line = (f"{name} step {i}: balance {a['balance']:.7f} reflection share "
            f"{share:.7f} rounds {int(t.trk_rounds)} lower reflections "
            f"{int(t.n_reflect_lower)} disk records {int(t.n_reflect_disk)}"
            f" dt {dt_used:.6e} s -> {dt_next:.6e} s (ladder {dt_new:.6e}"
            f" s, dT_max {float(out.dT_max):.4f})")
    if not abs(a["balance"] - (1.0 + share)) < AUDIT_TOL:
        raise AssertionError(f"reflection-corrected audit: {line}")
    if not (share > 0.0 and int(t.n_reflect_lower) > 0
            and int(t.n_reflect_disk) > 0):
        raise AssertionError(f"no reflection: {line}")
    want = dt0 if i == 0 else max(dt_new, dt_min)
    if not abs(dt_next - want) <= 1e-6 * want:
        raise AssertionError(f"adaptive dt {dt_next:.6e}, expected "
                             f"{want:.6e} (dt_min {dt_min:.6e}): {line}")
    return line


def check_ec_step(name, i, out, sim, a, src, dt_used, tea, t_start,
                  t_open) -> Tuple[str, bool]:
    t = out.tallies
    file_in = dt_used * float(torch.sum(sim.grid.area_lower
                                        * src.flux_lower))
    up = float(t.erlk_upper.sum()) * sim.scales.E
    line = (f"{name} step {i}: balance {a['balance']:.7f} file input "
            f"{file_in * sim.scales.E:.4e} erg erlk_upper {up:.4e} erg "
            f"rounds {int(t.trk_rounds)} FP substeps {int(out.fp_substeps)}"
            f" Te {float(tea.min()):.2f}-{float(tea.max()):.2f} keV")
    if not abs(a["balance"] - 1.0) < MRK_AUDIT_TOL:
        raise AssertionError(f"audit: {line}")
    opened = t_start + 0.5 * dt_used >= t_open
    if opened != (file_in > 0.0):
        raise AssertionError(f"file input against t0 {t_open:.6e}: {line}")
    if opened and not up > 0.0:
        raise AssertionError(f"nothing escaped upward: {line}")
    return line, opened


# the decks' runs in phase 7: (label, deck, deck options, timed steps,
# whether the flight kernel is checked on the run's own inputs). The
# disk deck at mcdt 3 starts dt0 at 3 dt_min, so that the FP ladder's dt
# lies above the floor and is what the steps apply
DECK_RUNS = (
    ("disk_deck", "disk_deck", {}, DECK_TIMED, True),
    ("disk_deck at mcdt 3", "disk_deck", {"mcdt": 3.0}, 2, False),
    ("ec_deck", "ec_deck", {}, DECK_TIMED, True),
)


def phase_decks(device, card: str) -> Tuple[int, int, dict]:
    """disk_deck and ec_deck, written in the reference's input format and
    loaded by the legacy importer, for DECK_WARM + DECK_TIMED steps each
    with every gate of their steps, and the disk deck again at mcdt 3 for
    DECK_WARM + 2 steps; then the flight kernel against its plain version
    on each deck's own inputs of its first timed step's first round.
    Returns the kernel's launches on the disk deck's runs (tables in
    shared memory) and on the blazar blob's (10x5 tables in global
    memory), and the blazar blob's kernel check (check_kernel's dict)."""
    plain_runs = [0]
    reference = flight.flight_step_reference
    flare_zones, fp_step = driver.flare_zones, driver.fp_step
    kernel_step = flight.flight_step
    boosts, dt_new, captured = [], [], {}
    capture = {"as": None}

    def counted_reference(*a, **k):
        plain_runs[0] += 1
        return reference(*a, **k)

    def recorded(zones, grid, fl, t, scales):
        out = flare_zones(zones, grid, fl, t, scales)
        if fl.enabled:
            boosts.append((float(t), (out.turb_lev - zones.turb_lev).cpu()))
        return out

    def recorded_fp(*a, **k):
        res = fp_step(*a, **k)
        dt_new.append(float(res.dt_new))
        return res

    def captured_step(*a, **k):
        # the first round of the step that capture["as"] names: its inputs
        # as the path hands them to the wrapper
        if capture["as"] is not None:
            names = ("e", "w", "w0", "r", "z", "mu", "cphi", "sphi", "dcen",
                     "jz", "kr", "alive")
            captured[capture["as"]] = (
                {f: x.clone() for f, x in zip(names, a[:12])}, a[12],
                a[13].clone(), dict(k))
            capture["as"] = None
        return kernel_step(*a, **k)

    flight.flight_step_reference = counted_reference
    flight.flight_step = captured_step
    driver.flare_zones, driver.fp_step = recorded, recorded_fp
    launches = {"disk_deck": 0, "ec_deck": 0}
    try:
        for label, name, opts, n_timed, check in DECK_RUNS:
            sim = decks.deck_sim(name, device, **opts)
            dt0 = float(sim.state.dt)
            record: list = []
            boosts.clear()
            dt_new.clear()
            flight.reset_launch_counts()
            outs = drive_deck(sim, DECK_WARM, record)
            torch.cuda.synchronize()
            capture["as"] = label if check else None
            t0 = time.perf_counter()
            outs += drive_deck(sim, n_timed, record)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            n_launch, n_global = flight.LAUNCHES, flight.GLOBAL_LAUNCHES
            placed = (n_global == 0) if name == "disk_deck" \
                else (n_global == n_launch)
            if not (n_launch > 0 and placed and plain_runs[0] == 0
                    and flight.STRAT_LAUNCHES == flight.PAIR_LAUNCHES
                    == flight.WINDOW_LAUNCHES == 0):
                raise AssertionError(
                    f"{label} launches: inline {n_launch} global-table "
                    f"{n_global} strat {flight.STRAT_LAUNCHES} pair "
                    f"{flight.PAIR_LAUNCHES} windowed "
                    f"{flight.WINDOW_LAUNCHES} plain {plain_runs[0]}")
            if state_devices(sim.state) != {"cuda"}:
                raise AssertionError(f"{label}: state tensors off the card")
            g = sim.grid
            dt_min = (min(float(torch.min(torch.diff(g.r_edges))),
                          float(g.dz)) * sim.scales.L / 2.99792458e10)
            if len(dt_new) != len(outs):
                raise AssertionError(f"{label}: {len(dt_new)} FP solves "
                                     f"in {len(outs)} steps")
            t_start, n_off, n_ladder = 0.0, 0, 0
            for i, out in enumerate(outs):
                sim.last_outputs = out
                a, share = audit_share(sim)
                src, dt_used, tea = record[i]
                if name == "disk_deck":
                    dt_next = (record[i + 1][1] if i + 1 < len(record)
                               else float(sim.state.dt))
                    log(check_disk_step(label, i, out, sim, a, share,
                                        dt_used, dt_next, dt0, dt_min,
                                        dt_new[i]))
                    n_ladder += i >= 1 and dt_new[i] > dt_min * (1 + 1e-6)
                else:
                    line, opened = check_ec_step(
                        label, i, out, sim, a, src, dt_used, tea, t_start,
                        float(sim.window_sources.t0[0]))
                    log(line)
                    n_off += not opened
                t_start += dt_used
            if name == "ec_deck" and n_off != 2:
                raise AssertionError(f"ec_deck: {n_off} steps without the "
                                     "file, expected the first 2")
            if opts and n_ladder == 0:
                raise AssertionError(f"{label}: no step applied the FP "
                                     "ladder's dt above dt_min")
            tea = sim.state.zones.tea
            if not bool(torch.all(torch.isfinite(tea))):
                raise AssertionError(f"{label}: non-finite zone "
                                     "temperatures")
            timed = outs[DECK_WARM:]
            histories = sum(int(o.n_tracked) for o in timed)
            log(f"{label} on {card}: {1e3 * elapsed / n_timed:.3f} "
                f"ms/step, {histories / elapsed:.6e} histories/s, "
                f"{per_step(timed, 'trk_rounds'):.2f} rounds/step, "
                f"{n_launch / len(outs):.2f} B1 launches/step "
                f"({'global' if n_global else 'shared'} tables), "
                f"{per_step(timed, 'n_reflect_lower'):.1f} lower "
                f"reflections/step, {per_step(timed, 'n_reflect_disk'):.1f} "
                f"disk records/step, FP substeps/step "
                f"{sum(int(o.fp_substeps) for o in timed) / n_timed:.2f}, "
                f"{n_ladder} steps on the ladder above dt_min "
                f"({n_timed} timed steps after {DECK_WARM} warm-up); "
                f"{sim.summary()}")
            launches[name] += n_launch
            if label == "disk_deck":
                check_flare(sim, boosts)
                check_deck_repeatable(name, device, outs)
            del sim, outs, timed
    finally:
        flight.flight_step_reference = reference
        flight.flight_step = kernel_step
        driver.flare_zones, driver.fp_step = flare_zones, fp_step
    # the kernel on each deck's own inputs (launches outside the counted
    # runs): the disk deck's 8x4 tables in shared memory, the blazar
    # blob's 10x5 ones in global memory
    checks = {}
    for label, placement in (("disk_deck", "shared"), ("ec_deck", "global")):
        photons, tables, seeds, k = captured[label]
        kw = dict(nz=k["nz"], nr=k["nr"], inline=k["inline_scatter"],
                  pairs=k["pair_switch"], weight_floor=k["weight_floor"],
                  max_tries=k["max_tries"])
        checks[label] = check_kernel(device, f"{label} kernel", photons,
                                     tables, seeds, k["max_iters"], kw,
                                     placement)
        del photons, tables, seeds
    return launches["disk_deck"], launches["ec_deck"], checks["ec_deck"]


def check_flare(sim, boosts: list) -> None:
    """The flare's turb_lev boost reaches the FP solve: largest at the step
    that starts nearest t_flare, in a zone next to the flare's centre."""
    fl = sim.cfg.physics.flare
    times = [t for t, _ in boosts]
    peak = int(np.argmin([abs(t - fl.t_flare) for t in times]))
    tops = [float(b.max()) for _, b in boosts]
    zone = np.unravel_index(int(torch.argmax(boosts[peak][1])),
                            tuple(boosts[peak][1].shape))
    g = sim.cfg.grid
    r_mid = (np.arange(g.nr) + 0.5) * g.r_max / g.nr
    z_mid = (np.arange(g.nz) + 0.5) * g.z_max / g.nz
    near_r = np.abs(r_mid - fl.r_flare).min()
    near_z = np.abs(z_mid - fl.z_flare).min()
    log(f"flare: boosts {['%.4f' % x for x in tops]} at t "
        f"{['%.4e' % t for t in times]} s; peak step {peak} zone {zone}")
    if not (tops[peak] == max(tops) and tops[peak] > 0.05
            and abs(r_mid[zone[1]] - fl.r_flare) == near_r
            and abs(z_mid[zone[0]] - fl.z_flare) == near_z):
        raise AssertionError("the flare's boost is not at its peak step "
                             "and zone")


def check_deck_repeatable(name: str, device, outs) -> None:
    sim = decks.deck_sim(name, device)
    for i in range(DECK_REPEAT):
        o2 = sim.step()
        for f in o2.tallies._fields:
            if not torch.equal(getattr(o2.tallies, f),
                               getattr(outs[i].tallies, f)):
                raise AssertionError(f"{name} step {i}: tally {f} not "
                                     "repeatable")
    log(f"{name}: tallies bitwise repeatable from the seed "
        f"({DECK_REPEAT} steps)")


# ---------------------------------------------------------------------------
# phase 8: the production run
# ---------------------------------------------------------------------------
def slice_sim(device, seed: int = 0, coulomb: bool = True):
    """The production run's corona: the main path with the Coulomb FP
    drift (or, for the comparison, without it)."""
    return bench_sim(device, seed=seed, fp_include_coulomb=coulomb)


def state_tensors(state) -> list:
    """(name, tensor) of every tensor of a SimState and its generator's
    state."""
    out = [("key", state.key.get_state())]
    for name in state._fields:
        leaf = getattr(state, name)
        if hasattr(leaf, "_fields"):
            out += [(f"{name}.{f}", getattr(leaf, f)) for f in leaf._fields]
        elif isinstance(leaf, torch.Tensor):
            out.append((name, leaf))
    return out


def tallies_equal(a, b) -> str:
    """The first tally (or the event records) that differ, or ''."""
    for f in a.tallies._fields:
        if not torch.equal(getattr(a.tallies, f), getattr(b.tallies, f)):
            return f
    return "" if torch.equal(a.events.data, b.events.data) else "events"


def check_resume(device, out_dir: str) -> int:
    """CKPT_FIRST steps, then run_to_stop with a walltime budget already
    spent saves a checkpoint and returns False; a fresh Simulation with the
    event file opened for append loads it and takes CKPT_RESUMED steps.
    Against an uninterrupted run of the sum of both: every SimState
    tensor and the generator's state, every step's tallies and the event
    file bitwise equal. Returns the flight kernel's launches."""
    n = CKPT_FIRST + CKPT_RESUMED
    flight.reset_launch_counts()
    first = slice_sim(device).attach_outputs(os.path.join(out_dir, "cut"))
    outs = [first.step() for _ in range(CKPT_FIRST)]
    ck = os.path.join(out_dir, "ck", "state.npz")
    if first.run_to_stop(walltime_budget_s=1e-9, checkpoint_path=ck):
        raise AssertionError("run_to_stop ran to t_stop, no checkpoint")
    meta = checkpoint.load_meta(ck)
    if not (meta["ncycle"] == int(first.state.ncycle) == CKPT_FIRST
            and meta["time"] == float(first.state.time)
            and meta["key_device"] == torch.device(device).type):
        raise AssertionError(f"checkpoint meta {meta}")
    resumed = driver.Simulation(first.cfg, first.zone_init, device=device)
    resumed.attach_outputs(os.path.join(out_dir, "cut"), resume=True)
    resumed.state = checkpoint.load_checkpoint(ck, resumed.state)
    outs += [resumed.step() for _ in range(CKPT_RESUMED)]
    torch.cuda.synchronize()
    launches = flight.LAUNCHES
    whole = slice_sim(device).attach_outputs(os.path.join(out_dir, "whole"))
    ref = [whole.step() for _ in range(n)]
    for i, (a, b) in enumerate(zip(outs, ref)):
        bad = tallies_equal(a, b)
        if bad:
            raise AssertionError(f"resume step {i}: {bad} differs")
    if state_devices(resumed.state) != {torch.device(device).type}:
        raise AssertionError("resumed state off the card")
    for (name, a), (_, b) in zip(state_tensors(resumed.state),
                                 state_tensors(whole.state)):
        if not (a.dtype == b.dtype and torch.equal(a, b)):
            raise AssertionError(f"resumed state {name} differs")
    ev_cut = os.path.join(out_dir, "cut", "evb.dat")
    ev_whole = os.path.join(out_dir, "whole", "evb.dat")
    with open(ev_cut, "rb") as fa, open(ev_whole, "rb") as fb:
        if fa.read() != fb.read():
            raise AssertionError("resumed event file differs")
    log(f"checkpoint: {CKPT_FIRST} + {CKPT_RESUMED} steps through "
        f"{os.path.getsize(ck)} bytes at ncycle {meta['ncycle']} equal "
        f"{n} uninterrupted steps bitwise (every state tensor, the "
        f"generator, each step's tallies, the event file of "
        f"{os.path.getsize(ev_whole)} bytes)")
    return launches


def dump_shapes(sim) -> dict:
    """{file: (rows, columns)} that the reference's write_diagnostics
    writes for ``sim`` with extras."""
    g = sim.cfg.grid
    nzr = g.nz * g.nr
    n_vol = sim.tables.e_ph.shape[0]
    shapes = {"icloss.dat": (g.num_nt * g.nphfield, 3),
              "seb.dat": (g.num_nt, 3), "nfield.dat": (g.nphfield, 2),
              "eic.dat": (g.num_nt, 2), "esp.dat": (g.num_nt, 2),
              "eloss_cy.dat": (g.nz, g.nr), "j_cy.dat": (nzr, n_vol)}
    for j in range(0, g.nz, 15):
        for k in range(0, g.nr, 5):
            name = f"fnt_{j + 1:02d}_{k + 1:02d}_{int(sim.state.ncycle):03d}"
            shapes[name + ".dat"] = (g.num_nt, 3)
    if sim.cfg.physics.pair_switch:
        shapes.update({"n_ph1.dat": (g.n_gg, 1 + nzr),
                       "n_ph2.dat": (g.n_gg, 1 + nzr),
                       "j_pa.dat": (nzr, n_vol)})
    return shapes


def check_dumps(sim, out_dir: str, label: str) -> None:
    """write_diagnostics with extras: every file the reference writes,
    with its rows and columns, finite."""
    t0 = time.perf_counter()
    driver.write_diagnostics(sim, out_dir, extras=True)
    secs = time.perf_counter() - t0
    want = dump_shapes(sim)
    if sorted(os.listdir(out_dir)) != sorted(want):
        raise AssertionError(f"{label} dumps {sorted(os.listdir(out_dir))}, "
                             f"expected {sorted(want)}")
    for name, shape in want.items():
        a = np.loadtxt(os.path.join(out_dir, name), ndmin=2)
        if a.shape != shape or not np.all(np.isfinite(a)):
            raise AssertionError(f"{label} {name}: {a.shape}, expected "
                                 f"{shape}, finite {np.isfinite(a).all()}")
    log(f"{label}: write_diagnostics(extras=True) wrote {len(want)} files "
        f"with the reference's rows and columns in {secs:.3f} s")


def check_photon_fill(sim, label: str, cycle_one: bool) -> None:
    """tests/test_fp.py:105-126's checks on photon_fill_diagnostic: every
    rate finite, dT_c nonzero in every zone, dT_sy <= 0, d_t_opt > 0, and
    at cycle 1 (after the first step, where the reference computes it and
    the JAX test checks it) some zone net cooling."""
    r = sim.photon_fill_diagnostic()
    for name, arr in r._asdict().items():
        if not bool(torch.all(torch.isfinite(arr))):
            raise AssertionError(f"photon_fill {name} not finite")
    if not (bool(torch.all(torch.abs(r.dT_c) > 0.0))
            and bool(torch.all(r.dT_sy <= 0.0))
            and bool(torch.all(r.d_t_opt > 0.0))
            and (float(r.dT_total.min()) < 0.0 or not cycle_one)):
        raise AssertionError(
            f"photon_fill {label}: |dT_c| min "
            f"{float(r.dT_c.abs().min()):.4e}, dT_sy max "
            f"{float(r.dT_sy.max()):.4e}, d_t_opt min "
            f"{float(r.d_t_opt.min()):.4e}, dT_total min "
            f"{float(r.dT_total.min()):.4e}")
    log(f"photon_fill {label}: dT_total [{float(r.dT_total.min()):.4e}, "
        f"{float(r.dT_total.max()):.4e}] keV/s, dT_c "
        f"[{float(r.dT_c.min()):.4e}, {float(r.dT_c.max()):.4e}] erg/s, "
        f"d_t_opt min {float(r.d_t_opt.min()):.4e} s")


def time_fp_terms(args: tuple, kwargs: dict) -> None:
    """fp_step on the Coulomb run's own inputs of its first timed step,
    with the Coulomb terms and without them (the same zones and field),
    FP_TURNS times each in turns: the medians, and the substeps."""
    phys = args[9]
    runs = {
        "with": (args, kwargs),
        "without": (args[:9] + (dataclasses.replace(
            phys, fp_include_coulomb=False),) + args[10:],
            dict(kwargs, coulomb=None)),
    }
    times = {name: [] for name in runs}
    subs = {}
    for turn in range(FP_TURNS):
        for name in (("with", "without") if turn % 2 == 0
                     else ("without", "with")):
            a, k = runs[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = driver.fp_step(*a, **k)
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0))
            subs[name] = int(res.substeps)
    log("fp_step on the Coulomb run's inputs (first timed step), "
        f"{FP_TURNS} calls each in turns: with the Coulomb terms "
        f"{statistics.median(times['with']):.3f} ms ({subs['with']} "
        f"substeps), without {statistics.median(times['without']):.3f} ms "
        f"({subs['without']} substeps); all with "
        f"{['%.3f' % t for t in times['with']]}, without "
        f"{['%.3f' % t for t in times['without']]}")


def phase_production(device, card: str) -> Tuple[int, dict]:
    """The Coulomb corona for COUL_WARM + COUL_TIMED steps with every
    step's gates, twice from the seed and once without the Coulomb terms;
    the flight kernel against its plain version on its first timed
    step's first round; checkpoint and resume; the diagnostic dumps and
    photon_fill after the Coulomb run and after PAIR_DUMP_STEPS steps of
    the pair corona. Returns the kernel's launches on the Coulomb run and
    the resume check, and its kernel check (check_kernel's dict)."""
    n = COUL_WARM + COUL_TIMED
    t0 = time.perf_counter()
    coulomb.build_coulomb_tables(np.asarray(gnt_grid(NUM_NT), np.float32),
                                 device=device)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim = slice_sim(device)
    init_s = time.perf_counter() - t0
    log(f"Coulomb tables ({NUM_NT} gamma bins, 24 Te x 8 Tp) built in "
        f"{build_s:.3f} s on the host ({os.cpu_count()} cores); "
        f"Simulation with them in {init_s:.3f} s (memoised)")
    plain_runs = [0]
    reference, kernel_step = flight.flight_step_reference, flight.flight_step
    fp_step = driver.fp_step
    captured = {}

    def counted_reference(*a, **k):
        plain_runs[0] += 1
        return reference(*a, **k)

    def captured_step(*a, **k):
        if captured.get("armed"):
            names = PhotonArray._fields
            captured.update(armed=False, args=(
                {f: x.clone() for f, x in zip(names, a[:12])}, a[12],
                a[13].clone(), dict(k)))
        return kernel_step(*a, **k)

    def captured_fp(*a, **k):
        if captured.get("fp_armed"):
            captured.update(fp_armed=False, fp_args=(a, k))
        return fp_step(*a, **k)

    flight.flight_step_reference = counted_reference
    flight.flight_step = captured_step
    driver.fp_step = captured_fp
    try:
        flight.reset_launch_counts()
        outs = [sim.step()]
        check_photon_fill(sim, "at cycle 1", cycle_one=True)
        outs += [sim.step() for _ in range(COUL_WARM - 1)]
        captured["armed"] = captured["fp_armed"] = True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs += [sim.step() for _ in range(COUL_TIMED)]
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    finally:
        flight.flight_step_reference = reference
        flight.flight_step = kernel_step
        driver.fp_step = fp_step
    launches = flight.LAUNCHES
    if not (launches > 0 and plain_runs[0] == 0 and flight.GLOBAL_LAUNCHES
            == flight.STRAT_LAUNCHES == flight.PAIR_LAUNCHES
            == flight.WINDOW_LAUNCHES == 0):
        raise AssertionError(
            f"Coulomb run launches: inline {launches} plain {plain_runs[0]} "
            f"global-table {flight.GLOBAL_LAUNCHES} strat "
            f"{flight.STRAT_LAUNCHES} pair {flight.PAIR_LAUNCHES} windowed "
            f"{flight.WINDOW_LAUNCHES}")
    dev_type = torch.device(device).type
    if state_devices(sim.state) != {dev_type} or any(
            t.device.type != dev_type for t in sim.coulomb_tables):
        raise AssertionError("Coulomb run: tensors off the card")
    for i, out in enumerate(outs):
        sim.last_outputs = out
        a = sim.energy_audit()
        if not abs(a["balance"] - 1.0) < AUDIT_TOL:
            raise AssertionError(f"Coulomb step {i}: audit {a['balance']}")
        log(f"Coulomb step {i}: balance {a['balance']:.7f} escaped "
            f"{a['escaped']:.4e} erg FP substeps {int(out.fp_substeps)} "
            f"fp_incomplete {int(out.fp_incomplete)} dT_max "
            f"{float(out.dT_max):.4f}")
    tea = sim.state.zones.tea
    if not bool(torch.all(torch.isfinite(tea))):
        raise AssertionError("Coulomb run: non-finite zone temperatures")
    timed = outs[COUL_WARM:]
    histories = sum(int(o.n_tracked) for o in timed)
    sub = [int(o.fp_substeps) for o in outs]
    log(f"Coulomb corona on {card}: {1e3 * elapsed / COUL_TIMED:.3f} "
        f"ms/step, {histories / elapsed:.6e} histories/s, "
        f"{sum(sub[COUL_WARM:]) / COUL_TIMED:.2f} FP substeps/step, "
        f"{launches} B1 launches in {n} steps, "
        f"{per_step(timed, 'trk_rounds'):.2f} rounds/step, tables built in "
        f"{build_s:.3f} s ({COUL_TIMED} timed steps after {COUL_WARM} "
        f"warm-up); {sim.summary()}")

    # twice from the seed: bitwise-equal tallies; without the Coulomb
    # terms: the same steps, their temperatures and substeps beside
    again = slice_sim(device)
    off = slice_sim(device, coulomb=False)
    sub_off = []
    for i in range(n):
        bad = tallies_equal(again.step(), outs[i])
        if bad:
            raise AssertionError(f"Coulomb step {i}: tally {bad} not "
                                 "repeatable")
        sub_off.append(int(off.step().fp_substeps))
    time_fp_terms(*captured["fp_args"])
    te_on = float(sim.state.zones.tea.mean())
    te_off = float(off.state.zones.tea.mean())
    gap = float(torch.max(torch.abs(sim.state.zones.f_nt
                                    - off.state.zones.f_nt)))
    log(f"Coulomb run: tallies bitwise repeatable from the seed ({n} "
        f"steps); mean Te after {n} steps {te_on:.4f} keV with the Coulomb "
        f"terms, {te_off:.4f} keV without; FP substeps/step "
        f"{sum(sub) / n:.2f} with, {sum(sub_off) / n:.2f} without; "
        f"max |f_nt difference| {gap:.4e}")
    if not gap > 0.0:
        raise AssertionError("the Coulomb terms changed no electron "
                             "distribution")

    with tempfile.TemporaryDirectory() as tmp:
        check_dumps(sim, os.path.join(tmp, "coulomb"), "Coulomb run")
        check_photon_fill(sim, f"after {n} steps", cycle_one=False)
        pairs_sim = pair_sim(device)
        for _ in range(PAIR_DUMP_STEPS):
            pairs_sim.step()
        check_dumps(pairs_sim, os.path.join(tmp, "pairs"), "pair corona")
        del pairs_sim
        launches += check_resume(device, tmp)
    del sim, again, off, outs, timed

    photons, tables, seeds, k = captured["args"]
    kw = dict(nz=k["nz"], nr=k["nr"], inline=k["inline_scatter"],
              pairs=k["pair_switch"], weight_floor=k["weight_floor"],
              max_tries=k["max_tries"])
    check = check_kernel(device, "Coulomb kernel", photons, tables, seeds,
                         k["max_iters"], kw, "shared")
    return launches, check


# ---------------------------------------------------------------------------
# phase 9: two ranks on one card
# ---------------------------------------------------------------------------
RANKS = 2
P9_WARM, P9_TIMED, P9_FARM_STEPS, P9_CUT = 2, 4, 3, 2
# the 1-vs-2-rank test: seeds a side, steps a seed, tools/pallas_e2e.py's
# channels (its z threshold and relative floor are e2e_gate's)
Z_SEEDS, Z_STEPS = 6, 3
Z_CHANNELS = ("escaped", "census", "edep_total", "scatter_gain", "te_mean")
ONE_RANK_SEED, TWO_RANK_SEED = 300, 400
RANKS_TIMEOUT, RANKS_INIT_TIMEOUT = 600.0, 120.0


def tensors_digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def zones_digest(sim) -> str:
    return tensors_digest(list(sim.state.zones))


def zone_differences(a, b) -> list:
    """(field, max |difference|) of every zone field that differs."""
    return [(f, float(torch.max(torch.abs(getattr(a, f).double()
                                          - getattr(b, f).double()))))
            for f in a._fields if not torch.equal(getattr(a, f),
                                                  getattr(b, f))]


def z_channels(sim, out) -> dict:
    """tools/pallas_e2e.py's channels of a replicate after its last step."""
    a = sim.energy_audit()
    return {"escaped": a["escaped"], "census": a["census"],
            "edep_total": float(torch.abs(out.tallies.edep).sum()),
            "scatter_gain": a["scatter_gain"],
            "te_mean": float(sim.state.zones.tea.mean())}


def z_side(device, seed0: int, mesh=None) -> Tuple[list, float]:
    """Z_SEEDS replicates of Z_STEPS steps: their channels, and the
    ms/step over all their steps."""
    reps, steps_s = [], 0.0
    for k in range(Z_SEEDS):
        sim = bench_sim(device, seed=seed0 + k, mesh=mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(Z_STEPS):
            out = sim.step()
        torch.cuda.synchronize()
        steps_s += time.perf_counter() - t0
        reps.append(z_channels(sim, out))
    return reps, 1e3 * steps_s / (Z_SEEDS * Z_STEPS)


def rank_main_path(mesh, device) -> dict:
    """The sharded main path on this rank: P9_WARM + P9_TIMED steps, its
    gates' readings, and the flight kernel's inputs of the first timed
    step's first round."""
    captured, local_substeps = {}, []
    kernel_step, fp_step = flight.flight_step, driver.fp_step

    def counted_fp(*a, **k):
        res = fp_step(*a, **k)
        local_substeps.append(int(res.substeps))
        return res

    def captured_step(*a, **k):
        if captured.get("armed"):
            names = PhotonArray._fields
            captured.update(armed=False, args=(
                {f: x.clone() for f, x in zip(names, a[:12])}, a[12],
                a[13].clone(), dict(k)))
        return kernel_step(*a, **k)

    sim = bench_sim(device, mesh=mesh)
    flight.flight_step = captured_step
    driver.fp_step = counted_fp
    try:
        flight.reset_launch_counts()
        outs = [sim.step() for _ in range(P9_WARM)]
        captured["armed"] = True
        torch.cuda.synchronize()
        comm0, calls0, bytes0 = mesh.comm_s, mesh.comm_calls, mesh.comm_bytes
        t0 = time.perf_counter()
        timed_outs, sizes = collectives.step_exchanges(sim, P9_TIMED)
        outs += timed_outs
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    finally:
        flight.flight_step = kernel_step
        driver.fp_step = fp_step
    launches = flight.launch_counts()
    steps = []
    for out in outs:
        sim.last_outputs = out
        steps.append(dict(
            balance=sim.energy_audit()["balance"],
            substeps=int(out.fp_substeps), rounds=int(out.tallies.trk_rounds),
            tallies=tensors_digest(list(out.tallies))))
    timed = outs[P9_WARM:]
    return dict(
        launches=launches, steps=steps, zones=zones_digest(sim),
        local_substeps=local_substeps,
        te_finite=bool(torch.all(torch.isfinite(sim.state.zones.tea))),
        te=(float(sim.state.zones.tea.min()), float(sim.state.zones.tea.max())),
        ms_step=1e3 * elapsed / P9_TIMED,
        histories_s=sum(int(o.n_tracked) for o in timed) / elapsed,
        comm_ms_step=1e3 * (mesh.comm_s - comm0) / P9_TIMED,
        comm_calls_step=(mesh.comm_calls - calls0) / P9_TIMED,
        comm_bytes_step=(mesh.comm_bytes - bytes0) / P9_TIMED,
        exchanges=collectives.summary(sizes),
        slots=sim.state.photons.n_slots,
        outs=outs, captured=captured.get("args"), summary=sim.summary())


def rank_farm_and_repeat(mesh, device, ref_outs) -> dict:
    """zone_shard on (a second run from the seed, against the main path's
    first steps) and off, P9_FARM_STEPS steps each."""
    on = bench_sim(device, mesh=mesh)
    off = on.with_config(dataclasses.replace(on.cfg, run=dataclasses.replace(
        on.cfg.run, zone_shard=False)))
    repeat, farm = [], []
    ve_launches = []
    for i in range(P9_FARM_STEPS):
        emissivity.reset_launch_counts()
        a = on.step()
        ve_launches.append(emissivity.launch_counts()["volume_em"])
        b = off.step()
        bad = tallies_equal(a, ref_outs[i])
        if bad:
            repeat.append(f"step {i} {bad}")
        bad = tallies_equal(a, b)
        if bad:
            farm.append(f"step {i} {bad}")
    farm += [f"zones {f} max |diff| {d:.3e}"
             for f, d in zone_differences(on.state.zones, off.state.zones)]
    return dict(repeat=repeat, farm=farm, ve_launches=ve_launches,
                substeps_off=int(b.fp_substeps), substeps_on=int(a.fp_substeps))


def rank_resume(mesh, device, out_dir: str) -> dict:
    """P9_CUT steps, run_to_stop with the walltime guard tripped on the
    last rank only, P9_CUT steps of a fresh Simulation resumed from the
    checkpoint; against 2 P9_CUT uninterrupted steps."""
    cut = bench_sim(device, mesh=mesh).attach_outputs(
        os.path.join(out_dir, "cut"))
    outs = [cut.step() for _ in range(P9_CUT)]
    ck = os.path.join(out_dir, "ck", "state.npz")
    completed = cut.run_to_stop(
        walltime_budget_s=1e-9 if mesh.rank == mesh.world - 1 else 0.0,
        checkpoint_path=ck)
    resumed = driver.Simulation(cut.cfg, cut.zone_init, device=device,
                                mesh=mesh)
    resumed.attach_outputs(os.path.join(out_dir, "cut"), resume=True)
    resumed.state = checkpoint.load_checkpoint(ck, resumed.state, mesh=mesh)
    outs += [resumed.step() for _ in range(P9_CUT)]
    whole = bench_sim(device, mesh=mesh).attach_outputs(
        os.path.join(out_dir, "whole"))
    ref = [whole.step() for _ in range(2 * P9_CUT)]
    torch.cuda.synchronize()
    bad = [f"step {i} {t}" for i, (a, b) in enumerate(zip(outs, ref))
           for t in [tallies_equal(a, b)] if t]
    bad += [name for (name, a), (_, b) in zip(state_tensors(resumed.state),
                                              state_tensors(whole.state))
            if not (a.dtype == b.dtype and torch.equal(a, b))]
    return dict(completed=completed, differing=bad,
                files=(cut.event_writer.path, whole.event_writer.path),
                shard=checkpoint.shard_path(ck, mesh.rank))


def phase9_rank(mesh, out_dir: str) -> dict:
    """One rank's part of phase 9 (run in a process of its own)."""
    kernel_only()
    device = mesh.device
    torch.cuda.set_device(device)
    main = rank_main_path(mesh, device)
    outs, captured = main.pop("outs"), main.pop("captured")
    res = dict(main=main, farm=rank_farm_and_repeat(mesh, device, outs),
               resume=rank_resume(mesh, device, out_dir))
    del outs
    res["z"], res["z_ms_step"] = z_side(device, TWO_RANK_SEED, mesh)
    if mesh.rank == 0:
        photons, tables, seeds, k = captured
        kw = dict(nz=k["nz"], nr=k["nr"], inline=k["inline_scatter"],
                  pairs=k["pair_switch"], weight_floor=k["weight_floor"],
                  max_tries=k["max_tries"])
        res["kernel"] = check_kernel(device, "two-rank kernel (rank 0)",
                                     photons, tables, seeds, k["max_iters"],
                                     kw, "shared")
    return res


def z_test(one: list, two: list) -> dict:
    """e2e_gate's test (tools/pallas_e2e.py's) of each channel, 2 ranks
    against 1: the relative deviation of the means against the relative
    1-sigma error of their difference (the noise floor); a channel passes
    with z < CAL_MULT or a deviation below REL_FLOOR."""
    out = {}
    for q in Z_CHANNELS:
        dev, sig, ok = e2e_gate.z_test([r[q] for r in two],
                                       [r[q] for r in one])
        out[q] = dict(rel_dev=dev, noise_floor=sig, passed=ok)
    return out


def phase_ranks(device, card: str) -> Tuple[int, dict]:
    """Phase 9: returns both ranks' flight kernel launches on the sharded
    main path and rank 0's kernel check (check_kernel's dict)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res = distributed.run_ranks(
            phase9_rank, RANKS, (os.path.join(tmp, "out"),), backend="gloo",
            device=device, timeout_s=RANKS_TIMEOUT,
            init_timeout_s=RANKS_INIT_TIMEOUT, rendezvous_dir=tmp)
        ranks_s = time.perf_counter() - t0
        for rank, r in enumerate(res):
            rs = r["resume"]
            if rs["completed"] is not False or rs["differing"]:
                raise AssertionError(f"rank {rank} resume: completed "
                                     f"{rs['completed']}, differing "
                                     f"{rs['differing']}")
            for path in rs["files"]:
                if not os.path.basename(path).startswith(f"p{rank:03d}_"):
                    raise AssertionError(f"rank {rank} event file {path}")
            with open(rs["files"][0], "rb") as fa, \
                    open(rs["files"][1], "rb") as fb:
                ev = fa.read()
                if ev != fb.read() or not ev:
                    raise AssertionError(f"rank {rank}: resumed event file "
                                         "differs or is empty")
            if not os.path.exists(rs["shard"]):
                raise AssertionError(f"rank {rank}: no checkpoint shard")
    ev_bytes = len(ev)
    launches = 0
    for rank, r in enumerate(res):
        m, f = r["main"], r["farm"]
        lc = m["launches"]
        if not (lc["inline"] > 0 and lc["strat"] == lc["pair"]
                == lc["window"] == lc["global_tables"] == 0):
            raise AssertionError(f"rank {rank} launches {lc}")
        launches += lc["inline"]
        if m["slots"] != N_SLOTS // RANKS or not m["te_finite"]:
            raise AssertionError(f"rank {rank}: {m['slots']} slots, Te "
                                 f"finite {m['te_finite']}")
        for i, st in enumerate(m["steps"]):
            if not abs(st["balance"] - 1.0) < AUDIT_TOL:
                raise AssertionError(f"rank {rank} step {i}: audit "
                                     f"{st['balance']}")
            if st["tallies"] != res[0]["main"]["steps"][i]["tallies"]:
                raise AssertionError(f"step {i}: tallies differ across "
                                     "ranks")
        if m["zones"] != res[0]["main"]["zones"]:
            raise AssertionError("zone state differs across ranks")
        if f["repeat"] or f["farm"]:
            raise AssertionError(f"rank {rank}: not repeatable {f['repeat']}"
                                 f"; zone_shard on vs off {f['farm']}")
        if f["ve_launches"] != [1] * P9_FARM_STEPS:
            raise AssertionError(f"rank {rank}: volume_em launches "
                                 f"{f['ve_launches']} in zone_shard steps")
        ex = m["exchanges"]
        if not ex["steps_equal"] or ex["bytes_per_step"][0] != m[
                "comm_bytes_step"]:
            raise AssertionError(f"rank {rank} collectives {ex}")
        log(f"two ranks, rank {rank} collectives: {ex['exchanges_per_step']} "
            f"exchanges a step of {ex['sizes']} bytes, "
            f"{ex['bytes_per_step']} bytes a step, the same every step")
        log(f"two ranks, rank {rank} on {card}: {m['ms_step']:.3f} ms/step, "
            f"{m['histories_s']:.6e} histories/s (both ranks' photons), "
            f"collective {m['comm_ms_step']:.3f} ms/step in "
            f"{m['comm_calls_step']:.1f} all_gathers of "
            f"{m['comm_bytes_step']:.0f} bytes from this rank, "
            f"{lc['inline']} B1 "
            f"launches in {P9_WARM + P9_TIMED} steps, FP substeps/step "
            f"{[st['substeps'] for st in m['steps']]} (the largest over the "
            f"ranks; this rank's zones {m['local_substeps']}), rounds/step "
            f"{[st['rounds'] for st in m['steps']]} (summed over the "
            f"ranks), Te [{m['te'][0]:.3f}, "
            f"{m['te'][1]:.3f}] keV; {m['summary']}")
    log(f"two ranks: every step's audit within {AUDIT_TOL} on both ranks "
        f"(balances {[round(st['balance'], 7) for st in res[0]['main']['steps']]}"
        f"), tallies and zone state bitwise equal across the ranks, "
        f"repeatable from the seed ({P9_FARM_STEPS} steps), zone_shard on "
        f"equal to off ({P9_FARM_STEPS} steps, FP substeps "
        f"{res[0]['farm']['substeps_on']} and "
        f"{res[0]['farm']['substeps_off']}), {P9_CUT} + {P9_CUT} steps "
        f"through a checkpoint (guard tripped on rank {RANKS - 1} only) "
        f"equal to {2 * P9_CUT} (both pNNN_evb.dat, rank 1's {ev_bytes} "
        f"bytes); the ranks took {ranks_s:.2f} s from spawn to join")
    one, one_ms = z_side(device, ONE_RANK_SEED)
    two = res[0]["z"]
    if any(r["z"] != two for r in res):
        raise AssertionError("z-test channels differ across ranks")
    zt = z_test(one, two)
    for q, v in zt.items():
        log(f"1 vs 2 ranks {q}: rel_dev {v['rel_dev']:.6e} noise_floor "
            f"{v['noise_floor']:.6e} z {v['rel_dev'] / max(v['noise_floor'], 1e-300):.3f} "
            f"{'pass' if v['passed'] else 'FAIL'}")
    log(f"1 vs 2 ranks ({Z_SEEDS} seeds x {Z_STEPS} steps a side): "
        f"{one_ms:.3f} ms/step on 1 rank, {res[0]['z_ms_step']:.3f} "
        f"ms/step on 2 ranks")
    if not all(v["passed"] for v in zt.values()):
        raise AssertionError(f"1 vs 2 ranks: {zt}")
    return launches, res[0]["kernel"]


# ---------------------------------------------------------------------------
# phase 10: the gate against the reference's Pallas kernel at bench size
# ---------------------------------------------------------------------------
def gate_launches_ok(cell: str, plain_runs: int) -> bool:
    """The cell's flight-kernel mode only, and no plain-version run: B1
    with shared tables (main_path), B2 (pair_corona), B2 with B3
    (pair_corona_strat), B4 (grid_40x30)."""
    inline, pair = flight.LAUNCHES, flight.PAIR_LAUNCHES
    window, glob = flight.WINDOW_LAUNCHES, flight.GLOBAL_LAUNCHES
    strat = flight.STRAT_LAUNCHES
    mode = e2e_gate.CELL_MODE[cell]
    if plain_runs:
        return False
    if mode == "B2+B3":
        return strat > 0 and pair == strat and inline == window == glob == 0
    if strat or inline <= 0:
        return False
    if mode == "B1":
        return pair == window == glob == 0
    if mode == "B2":
        return pair == inline and window == glob == 0
    return window == inline == glob and pair == 0


def phase_gate(device, card: str) -> Tuple[dict, dict]:
    """Each cell of the committed reference JSON: the port's config equal
    to the recorded one field for field, K seeds of the recorded statistic
    on the card, e2e_gate.gate against the reference's replicates; returns
    the launches of each cell and its gate dict."""
    ref = e2e_gate.load_reference()
    plain_runs = [0]
    reference = flight.flight_step_reference

    def counted_reference(*a, **k):
        plain_runs[0] += 1
        return reference(*a, **k)

    launches, results = {}, {}
    flight.flight_step_reference = counted_reference
    try:
        for cell in e2e_gate.CELLS:
            rc = ref[cell]
            t0 = time.perf_counter()
            sim = e2e_gate.build_cell(cell, rc["statistic"], device)
            bad = e2e_gate.check_config(sim, rc)
            if bad:
                raise AssertionError(f"gate {cell}: config differs from the "
                                     f"reference's in {bad}")
            k = len(rc["seeds"])
            plain_runs[0] = 0
            flight.reset_launch_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            reps = e2e_gate.port_replicates(sim, rc)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t1
            if not gate_launches_ok(cell, plain_runs[0]):
                raise AssertionError(
                    f"gate {cell} launches: inline {flight.LAUNCHES} pair "
                    f"{flight.PAIR_LAUNCHES} windowed {flight.WINDOW_LAUNCHES}"
                    f" global-table {flight.GLOBAL_LAUNCHES} strat "
                    f"{flight.STRAT_LAUNCHES} plain {plain_runs[0]}")
            launches[cell] = (flight.STRAT_LAUNCHES
                              if e2e_gate.CELL_MODE[cell] == "B2+B3"
                              else flight.LAUNCHES)
            res = results[cell] = e2e_gate.gate(reps, rc)
            full = e2e_gate.gate(reps, rc, ndigits=None)
            for q, dev in full["rel_dev"].items():
                fl = full["noise_floor"][q]
                check = res["checks"].get(f"rel_{q}", res["checks"].get(q))
                if q == "te_worst_zone":
                    check = res["checks"]["te_zones"]
                z = f"{dev / fl:.3f}" if fl > 0 else "n/a (floor 0)"
                log(f"gate {cell} {q}: rel_dev {dev:.6e} noise_floor "
                    f"{fl:.6e} z {z} {'pass' if check else 'FAIL'}")
            log(f"gate {cell} ({e2e_gate.CELL_MODE[cell]}, statistic "
                f"{rc['statistic']}, {rc['steps']} steps, {k} seeds a side) "
                f"on {card}: checks {res['checks']}, stiff zones "
                f"{res['n_stiff_zones']}, worst |balance - 1| port "
                f"{res['balance_pallas_worst']:.3e} reference "
                f"{res['balance_xla_worst']:.3e}, mean Te port "
                f"{np.mean([r['te_mean'] for r in reps]):.4f} reference "
                f"{np.mean([r['te_mean'] for r in rc['replicates']]):.4f} "
                f"keV, source energy lost to full slots port "
                f"{np.mean([r['src_lost'] for r in reps]):.4e} reference "
                f"{np.mean([r['src_lost'] for r in rc['replicates']]):.4e} "
                f"erg; {launches[cell]} launches, "
                f"{1e3 * run_s / (k * rc['steps']):.3f} ms/step, "
                f"{run_s:.2f} s for the replicates, "
                f"{time.perf_counter() - t0:.2f} s with the set-up "
                f"(reference: {rc['cpu_seconds']:.1f} CPU s, jax "
                f"{rc['jax_version']})")
            te_p = np.stack([r["te"] for r in reps])
            te_x = np.asarray([r["te"] for r in rc["replicates"]])
            sig = np.sqrt(te_p.var(0, ddof=1) / k + te_x.var(0, ddof=1) / k)
            dev = np.abs(te_p.mean(0) - te_x.mean(0))
            z = dev / np.maximum(sig, 1e-30)
            # the zones behind te_worst_zone's deviation and floor, and
            # every failing zone
            shown = {np.unravel_index(np.argmax(dev), dev.shape),
                     np.unravel_index(np.argmax(sig), sig.shape),
                     *zip(*np.nonzero(z >= e2e_gate.CAL_MULT))}
            for j, i in sorted(shown):
                log(f"gate {cell} zone ({j}, {i}): Te port "
                    f"{te_p[:, j, i].mean():.4f} +- "
                    f"{te_p[:, j, i].std(ddof=1):.4f} reference "
                    f"{te_x[:, j, i].mean():.4f} +- "
                    f"{te_x[:, j, i].std(ddof=1):.4f} keV (seed spread), "
                    f"z {z[j, i]:.3f}")
            if not res["passed"]:
                raise AssertionError(f"gate {cell} failed: {res}")
            del sim, reps
    finally:
        flight.flight_step_reference = reference
    return launches, results


# ---------------------------------------------------------------------------
# phase 11: the port's two root entry points (bench, dry run)
# ---------------------------------------------------------------------------
BENCH_TIMEOUT = 900.0
BENCH_KEYS = ("metric", "value", "unit", "tracking_rounds_per_step",
              "step_hbm_model_pct_of_peak", "mrk421_histories_per_s",
              "pallas_e2e", "pallas_e2e_strat", "device")


def check_bench(card: str, gates: dict) -> dict:
    """``python -m compton2d_tpu_torch.bench`` in a process of its own at
    the default size: its last line one record with bench.py's keys, a
    positive rate, the main path's B1 launches, and both gate records
    passed and equal to phase 10's gates of the same cells (the same
    seeds, so the same replicates)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "compton2d_tpu_torch.bench"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=BENCH_TIMEOUT)
    bench_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"bench exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"bench record: {json.dumps(rec)}")
    log(f"bench stderr: {proc.stderr.strip().splitlines()[-1]}; "
        f"{bench_s:.2f} s for the process")
    missing = [k for k in BENCH_KEYS if k not in rec]
    if missing or "vs_baseline" in rec:
        raise AssertionError(f"bench record keys: missing {missing}")
    lc = rec["flight_launches"]
    if not (rec["value"] > 0 and rec["mrk421_histories_per_s"] > 0
            and lc["inline"] > 0 and lc["strat"] == lc["pair"]
            == lc["window"] == lc["global_tables"] == 0):
        raise AssertionError(f"bench: value {rec['value']}, launches {lc}")
    if rec["device"] != card:
        raise AssertionError(f"bench device {rec['device']!r}, card {card!r}")
    if rec["tracker"] != "kernel":
        raise AssertionError(f"bench tracker {rec['tracker']!r}")
    for key, cell in bench.GATES.items():
        g = rec[key]
        if g.get("passed") is not True:
            raise AssertionError(f"bench {key} ({cell}): {g}")
        want = {k: gates[cell][k] for k in bench.GATE_KEYS}
        if g != json.loads(json.dumps(want)):
            raise AssertionError(f"bench {key} differs from phase 10's "
                                 f"{cell}: {g} against {want}")
    return rec


def phase_entry_points(device, card: str, gates: dict) -> int:
    """Phase 11: the bench as a user runs it, and dryrun_multichip(2) on
    two gloo ranks sharing the card; returns the dry run's pair-mode
    launches (both ranks and the one-rank run)."""
    rec = check_bench(card, gates)
    log(f"bench on {card}: {rec['value']:.6e} histories/s, "
        f"{rec['tracking_rounds_per_step']} rounds/step, HBM model "
        f"{rec['step_hbm_model_pct_of_peak']:.6e}% of the step, Mrk 421 "
        f"{rec['mrk421_histories_per_s']:.6e} histories/s, gates passed "
        f"(pair_corona, pair_corona_strat)")
    flight.reset_launch_counts()
    t0 = time.perf_counter()
    dr = dryrun.dryrun_multichip(RANKS, device=device, backend="gloo")
    dr_s = time.perf_counter() - t0
    one = flight.launch_counts()
    if dr["trackers"] != ["kernel"] * (RANKS + 1):
        raise AssertionError(f"dry run trackers {dr['trackers']}")
    for lc in dr["launches"] + [one]:
        if not (lc["pair"] > 0 and lc["pair"] == lc["inline"]
                and lc["strat"] == lc["window"] == 0):
            raise AssertionError(f"dry run launches {dr['launches']}, one "
                                 f"rank {one}")
    log(f"dryrun_multichip({RANKS}) on {card}: {json.dumps(dr)}")
    log(f"dryrun_multichip({RANKS}): first-step budget {dr['bingo']!r} "
        f"(1 rank {dr['bingo_one_rank']!r}), roulette rolled {dr['n_rr']} "
        f"(1 rank {dr['n_rr_one_rank']}), event counts {dr['event_counts']}"
        f" with {dr['events_dropped']} records dropped a rank (capacity "
        f"{dr['capacity']}; 1 rank {dr['events_dropped_one_rank']}), "
        f"z {dr['z']}; {dr_s:.2f} s")
    return sum(lc["pair"] for lc in dr["launches"]) + one["pair"]


# ---------------------------------------------------------------------------
# phase 12: the lock-step flight loop
# ---------------------------------------------------------------------------
LOOP_WARM, LOOP_TIMED = 2, 4
# a grid the kernel refuses (an edge above flight.MAX_EDGE) at the main
# path's widths, and the main path at slots off the 1024 tile
HUGE_NZ, HUGE_NR, HUGE_SLOTS, HUGE_NST = 128, 128, 524288, 240000
HUGE_WARM, HUGE_TIMED = 1, 2
ODD_SLOTS, ODD_STEPS = 130000, 2


def kernel_only():
    """From here on every Simulation this process builds, and every step
    it takes, must select the flight kernel (``driver.select_tracker``
    raises otherwise): no earlier phase's path can drift onto the loop.
    Returns the unguarded selection, for :func:`phase_loop`."""
    select = driver.select_tracker

    def kernel_tracker(cfg, world=1):
        tracker = select(cfg, world)
        if tracker != "kernel":
            raise AssertionError(f"the {tracker} tracker selected outside "
                                 "phase 12")
        return tracker

    driver.select_tracker = kernel_tracker
    return select


class PhaseTimer:
    """Card-synchronised wall time of driver functions (inclusive, as
    ``profile_phases`` times them), summed over the calls while on."""

    def __init__(self, names):
        self.names, self.ms, self.on = names, {}, False
        self.orig = {n: getattr(driver, n) for n in names}
        for n in names:
            setattr(driver, n, self._timed(n, self.orig[n]))

    def _timed(self, name, fn):
        def wrapped(*a, **k):
            if not self.on:
                return fn(*a, **k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a, **k)
            torch.cuda.synchronize()
            self.ms[name] = self.ms.get(name, 0.0) + 1e3 * (
                time.perf_counter() - t0)
            return res
        return wrapped

    def restore(self):
        for n, fn in self.orig.items():
            setattr(driver, n, fn)


def loop_step_line(label: str, i: int, sim, out, ms: float,
                   tol: float) -> dict:
    """Log one step's audit, tracking iterations (or kernel rounds),
    stragglers and ms, and check the audit within ``tol``, the escapes,
    finite temperatures and the state on the card."""
    sim.last_outputs = out
    a = sim.energy_audit()
    t = out.tallies
    rec = dict(balance=a["balance"], rounds=int(t.trk_rounds),
               stragglers=int(t.n_straggler), ms=ms,
               tracked=int(out.n_tracked))
    log(f"{label} step {i}: balance {a['balance']:.7f} escaped "
        f"{a['escaped']:.4e} erg census {a['census']:.4e} erg "
        f"{'iterations' if sim.tracker == 'loop' else 'rounds'} "
        f"{rec['rounds']} stragglers {rec['stragglers']} tracked "
        f"{rec['tracked']} {ms:.3f} ms")
    if not abs(a["balance"] - 1.0) < tol:
        raise AssertionError(f"{label} step {i}: audit {a['balance']}")
    if not a["escaped"] > 0.0:
        raise AssertionError(f"{label} step {i}: nothing escaped")
    if not bool(torch.all(torch.isfinite(sim.state.zones.tea))):
        raise AssertionError(f"{label} step {i}: non-finite temperatures")
    if state_devices(sim.state) != {"cuda"}:
        raise AssertionError(f"{label}: state tensors left the card")
    return rec


def mean_of(recs: list, key: str) -> float:
    return sum(r[key] for r in recs) / len(recs)


def phase_loop(device, card: str, select) -> int:
    """Phase 12: (a) the main path on the loop ("off") and on the kernel
    in turns, 2 warm and 4 timed steps each; (b) the tracker_main gate,
    the kernel against the loop (e2e_gate.tracker_gate, 12 seeds a side);
    (c) a 128x128 grid at the main path's widths under "auto" on the
    loop, with no zone sort, its peak memory and its step split into
    volume_em, fp_step and transport_step, and "on" refusing it; (d) the
    main path at 130000 slots under "auto" on the loop. ``select`` is the
    unguarded tracker selection. Returns the B1 launches of (a) and
    (b)."""
    driver.select_tracker = select
    zone_sorts = [0]
    zone_sort = driver.zone_sort

    def counted_sort(*a, **k):
        zone_sorts[0] += 1
        return zone_sort(*a, **k)

    timer = PhaseTimer(("volume_em", "fp_step", "transport_step"))
    driver.zone_sort = counted_sort
    try:
        # (a) the main path on each tracker, in turns
        kern = bench_sim(device)
        loop = kern.with_config(dataclasses.replace(
            kern.cfg, run=dataclasses.replace(kern.cfg.run,
                                              pallas_tracking="off")))
        if (kern.tracker, loop.tracker) != ("kernel", "loop"):
            raise AssertionError(f"trackers {kern.tracker}, {loop.tracker}")
        recs = {"kernel": [], "loop": []}
        b1 = 0
        for i in range(LOOP_WARM + LOOP_TIMED):
            order = (kern, loop) if i % 2 == 0 else (loop, kern)
            for sim in order:
                timer.ms.clear()
                timer.on = True
                flight.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = sim.step()
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0)
                timer.on = False
                lc = flight.launch_counts()
                if sim.tracker == "loop" and any(lc.values()):
                    raise AssertionError(f"the loop launched the kernel: {lc}")
                if sim.tracker == "kernel" and not (
                        lc["inline"] > 0 and lc["strat"] == lc["pair"]
                        == lc["window"] == lc["global_tables"] == 0):
                    raise AssertionError(f"main path kernel launches {lc}")
                b1 += lc["inline"]
                rec = loop_step_line(f"phase 12 main path ({sim.tracker})",
                                     i, sim, out, ms, AUDIT_TOL)
                rec["transport_ms"] = timer.ms["transport_step"]
                if i >= LOOP_WARM:
                    recs[sim.tracker].append(rec)
        for name, rs in recs.items():
            log(f"phase 12 main path on the {name} tracker on {card}: "
                f"{mean_of(rs, 'ms'):.3f} ms/step, transport_step "
                f"{mean_of(rs, 'transport_ms'):.3f} ms/step, "
                f"{mean_of(rs, 'tracked') / (mean_of(rs, 'ms') / 1e3):.6e} "
                f"histories/s, {mean_of(rs, 'rounds'):.2f} "
                f"{'iterations' if name == 'loop' else 'rounds'}/step, "
                f"{mean_of(rs, 'stragglers'):.1f} stragglers/step "
                f"({LOOP_TIMED} timed steps after {LOOP_WARM} warm-up, in "
                f"turns; the card synchronised around transport_step)")
        del kern, loop

        # (b) the tracker_main gate: the kernel against the loop
        flight.reset_launch_counts()
        t0 = time.perf_counter()
        res = e2e_gate.tracker_gate(device)
        gate_s = time.perf_counter() - t0
        lc = flight.launch_counts()
        if not (lc["inline"] > 0 and lc["strat"] == lc["pair"]
                == lc["window"] == lc["global_tables"] == 0):
            raise AssertionError(f"tracker_main launches {lc}")
        b1 += lc["inline"]
        g = res["gate"]
        for q, dev in g["rel_dev"].items():
            fl = g["noise_floor"][q]
            z = f"{dev / fl:.3f}" if fl > 0 else "n/a (floor 0)"
            log(f"gate tracker_main {q}: rel_dev {dev:.6e} noise_floor "
                f"{fl:.6e} z {z}")
        log(f"gate tracker_main (main_path, kernel against loop, "
            f"{g['n_seeds']} seeds a side, statistic {res['statistic']}, "
            f"every scalar floor at or below {e2e_gate.FLOOR_TARGET}: "
            f"{res['floors_ok']}) on {card}: checks {g['checks']}, mean Te "
            f"kernel {res['te_mean']['kernel']:.4f} loop "
            f"{res['te_mean']['loop']:.4f} keV, worst |balance - 1| kernel "
            f"{g['balance_pallas_worst']:.3e} loop "
            f"{g['balance_xla_worst']:.3e}; {lc['inline']} B1 launches; "
            f"{gate_s:.2f} s")
        if not (g["passed"] and res["trackers"] == {"kernel": "kernel",
                                                    "loop": "loop"}
                and res["statistic"] == (e2e_gate.TRACKER_STATISTIC,
                                         e2e_gate.TRACKER_STEPS)):
            raise AssertionError(f"gate tracker_main failed: {res}")

        # (c) a grid the kernel refuses, on the loop
        on, zi = corona_config(nz=HUGE_NZ, nr=HUGE_NR, nst=HUGE_NST,
                               n_slots=HUGE_SLOTS, num_nt=NUM_NT,
                               n_vol=N_VOL, nphfield=400, t_const=False)
        on = dataclasses.replace(on, run=dataclasses.replace(
            on.run, pallas_tracking="on"))
        try:
            driver.Simulation(on, zi, device=device)
        except NotImplementedError as e:
            log(f"phase 12: pallas_tracking 'on' at {HUGE_NZ}x{HUGE_NR} "
                f"refused: {e}")
        else:
            raise AssertionError("'on' accepted a 128-zone edge")
        flight.reset_launch_counts()
        zone_sorts[0] = 0
        torch.cuda.reset_peak_memory_stats(device)
        sim = bench_sim(device, nz=HUGE_NZ, nr=HUGE_NR, nst=HUGE_NST,
                        n_slots=HUGE_SLOTS)
        if sim.tracker != "loop":
            raise AssertionError(f"{HUGE_NZ}x{HUGE_NR} on {sim.tracker}")
        recs, split = [], {}
        for i in range(HUGE_WARM + HUGE_TIMED):
            timer.ms.clear()
            timer.on = i >= HUGE_WARM
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = sim.step()
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            timer.on = False
            rec = loop_step_line(f"phase 12 {HUGE_NZ}x{HUGE_NR}", i, sim,
                                 out, ms, AUDIT_TOL)
            if i >= HUGE_WARM:
                recs.append(rec)
                for n, v in timer.ms.items():
                    split[n] = split.get(n, 0.0) + v / HUGE_TIMED
        peak = torch.cuda.max_memory_allocated(device)
        if any(flight.launch_counts().values()) or zone_sorts[0]:
            raise AssertionError(f"{HUGE_NZ}x{HUGE_NR}: launches "
                                 f"{flight.launch_counts()}, zone sorts "
                                 f"{zone_sorts[0]}")
        log(f"phase 12 {HUGE_NZ}x{HUGE_NR} (nst {HUGE_NST}, {HUGE_SLOTS} "
            f"slots, 'auto': the loop, no zone sort) on {card}: "
            f"{mean_of(recs, 'ms'):.3f} ms/step (the card synchronised "
            f"around each timed phase): volume_em {split['volume_em']:.3f}, "
            f"fp_step {split['fp_step']:.3f}, transport_step "
            f"{split['transport_step']:.3f} ms/step; "
            f"{mean_of(recs, 'rounds'):.2f} iterations/step, "
            f"{mean_of(recs, 'stragglers'):.1f} stragglers/step; peak "
            f"memory {peak} bytes ({HUGE_TIMED} timed steps after "
            f"{HUGE_WARM} warm-up)")
        del sim, out

        # (d) the main path at slots off the tile
        sim = bench_sim(device, n_slots=ODD_SLOTS)
        if sim.tracker != "loop":
            raise AssertionError(f"{ODD_SLOTS} slots on {sim.tracker}")
        for i in range(ODD_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = sim.step()
            torch.cuda.synchronize()
            loop_step_line(f"phase 12 main path at {ODD_SLOTS} slots", i,
                           sim, out, 1e3 * (time.perf_counter() - t0),
                           AUDIT_TOL)
        if any(flight.launch_counts().values()):
            raise AssertionError(f"{ODD_SLOTS} slots launched the kernel")
    finally:
        timer.restore()
        driver.zone_sort = zone_sort
    return b1


# ---------------------------------------------------------------------------
# phase 13: the FP substep kernel
# ---------------------------------------------------------------------------
# each cell's configuration (compare_fp.CELLS) and the main-path steps
# run after its set-up, the kernel compared on the last one's inputs
FP_CELLS = (("mrk421", 5), ("large_corona", 2))


def fp_events_ms(fn, turns: int) -> list:
    """CUDA events around each of ``turns`` calls of ``fn``, after one."""
    fn()
    out = []
    for _ in range(turns):
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        out.append(t0.elapsed_time(t1))
    return out


def phase_fp(device, card: str) -> list:
    """Phase 13 (module docstring): the kernel's launches on each cell's
    main path, the kernel against the plain loop and its times; returns
    the kernels line's entry of each cell."""
    update.build()
    log(f"fp substep kernel: {update.ptxas_report()}; a block of "
        f"{update.block_threads(200)} threads at num_nt 200, "
        f"{update.shared_bytes(update.block_threads(200), 512)} bytes of "
        "shared memory")
    entries = []
    for name, steps in FP_CELLS:
        sim, setup = compare_fp.cell_sim(name, device)
        sim.run(setup)
        update.reset_launch_counts()
        recorded = compare_fp.fp_args(sim, steps)
        torch.cuda.synchronize()
        launches = update.launch_counts()["fp_substeps"]
        log(f"fp {name}: {launches} kernel launches in {steps} main-path "
            f"steps after {setup} set-up steps ({len(recorded)} FP steps)")
        if not launches == len(recorded) == steps:
            raise AssertionError(f"fp {name}: {launches} launches, "
                                 f"{len(recorded)} FP steps in {steps}")
        args, kw = recorded[-1]
        c = compare_fp.compare(args, kw)
        torch.cuda.synchronize()
        log(compare_fp.describe(c, f"fp {name} step {setup + steps - 1}"))
        bad = compare_fp.departures(c)
        if bad:
            raise AssertionError(f"fp {name}: the kernel departs from the "
                                 f"plain loop: {bad}")
        kernel_ms = events_ms(update.launch_only(c.loop))
        step_k, step_p = [], []
        for turn in range(FP_TURNS):
            pair = [("k", None), ("p", update.substep_loop_reference)]
            for which, loop in (pair if turn % 2 == 0 else pair[::-1]):
                ms = fp_events_ms(
                    lambda: compare_fp.solve(args, kw, loop), 1)[0]
                (step_k if which == "k" else step_p).append(ms)
        nz, nr, num_nt = args[0].f_nt.shape
        zone_substeps = int(c.count.sum())
        bound = roofline.fp_kernel_bound(nz * nr, num_nt, zone_substeps)
        step_bound = roofline.fp_bound(nz * nr, num_nt, args[1].shape[-1],
                                       int(c.plain.substeps))
        ms_k, ms_p = statistics.median(step_k), statistics.median(step_p)
        log(f"fp {name} on {card}: kernel {kernel_ms:.4f} ms on the device "
            f"alone, bound {bound['bound_ms']:.6f} ms by {bound['bound_by']} "
            f"({bound['bytes']} bytes, {bound['ops']} operations for "
            f"{zone_substeps} zone-substeps), "
            f"{100 * bound['bound_ms'] / kernel_ms:.4f}% of it; fp_step "
            f"{ms_k:.3f} ms with the kernel, {ms_p:.3f} ms with the plain "
            f"loop (medians of {FP_TURNS} in turns: "
            f"{['%.3f' % t for t in step_k]}, "
            f"{['%.3f' % t for t in step_p]}), fp_step's bound (the "
            f"benchmark's model) {step_bound['bound_ms']:.6f} ms, "
            f"{100 * step_bound['bound_ms'] / ms_k:.4f}% of it")
        entries.append({
            "name": f"fp_substeps_kernel.{name}", "route": "cuda",
            "source": "compton2d_tpu_torch/csrc/fp_substeps.cu",
            "replaces": None, "library_ms": None, "launches": launches,
            "fp_steps": steps, "max_abs_err": c.f_nt, "tea_gap": c.te,
            "ms": kernel_ms, "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"], "zone_substeps": zone_substeps,
            "fp_step_ms": ms_k, "plain_ms": ms_p,
            "fp_step_bound_ms": step_bound["bound_ms"]})
    return entries


# ---------------------------------------------------------------------------
# phase 14: the synchrotron sums kernel
# ---------------------------------------------------------------------------
# each benchmark cell run on one card and the main-path steps run after its
# set-up, the kernel compared on the last one's inputs
VE_CELLS = (("mrk421_dense.to_tstop", 5), ("corona99.evolve", 1),
            ("pair_corona.evolve", 1))
VE_TURNS = 5


def phase_volume_em(device, card: str) -> list:
    """Phase 14 (module docstring): the kernel's launches on each cell's
    main path, the kernel against the plain version, the zone farm's
    slices against the whole grid, and the times; returns the kernels
    line's entry of each shape."""
    emissivity.build()
    log(f"volume_em kernel: {emissivity.ptxas_report()}; a block of "
        f"{emissivity.block_threads(400)} threads at n_vol 400, "
        f"{emissivity.shared_bytes(200)} bytes of shared memory at num_nt "
        "200")
    entries = []
    for cell, steps in VE_CELLS:
        sim, setup = compare_volume_em.cell_sim(cell, device)
        sim.run(setup)
        emissivity.reset_launch_counts()
        recorded = compare_volume_em.sums_inputs(sim, steps)
        torch.cuda.synchronize()
        launches = emissivity.launch_counts()["volume_em"]
        log(f"volume_em {cell}: {launches} kernel launches in {steps} "
            f"main-path steps after {setup} set-up steps")
        if not launches == len(recorded) == steps:
            raise AssertionError(f"volume_em {cell}: {launches} launches, "
                                 f"{len(recorded)} zone passes in {steps}")
        del sim
        x = recorded[-1]
        shapes = [(cell, x)]
        if cell == "corona99.evolve":
            # the zone farm's slices on corona99.ranks4's ranks
            j, k = emissivity.sync_sums(*x)
            Z = x.fw.shape[0]
            for rank in range(compare_volume_em.RANKS):
                idx = compare_volume_em.rank_zones(Z, rank)
                part = compare_volume_em.zone_part(x, idx)
                js, ks = emissivity.sync_sums(*part)
                if not (torch.equal(js, j[idx]) and torch.equal(ks, k[idx])):
                    raise AssertionError(f"volume_em rank {rank}'s slice "
                                         "differs from the whole grid")
                if rank == 0:
                    shapes.append(("corona99.ranks4 rank 0", part))
            log(f"volume_em corona99.ranks4: each rank's slice of "
                f"{len(idx)} zones bit for bit the whole grid's rows")
        for label, xi in shapes:
            c = compare_volume_em.compare(xi)
            torch.cuda.synchronize()
            log(compare_volume_em.describe(c, f"volume_em {label}"))
            bad = compare_volume_em.departures(c)
            if bad:
                raise AssertionError(f"volume_em {label}: the kernel departs "
                                     f"from the plain version: {bad}")
            kernel_ms = events_ms(emissivity.launch_only(*xi))
            plain = fp_events_ms(
                lambda: emissivity.sync_sums_reference(*xi), VE_TURNS)
            Z, N = xi.fw.shape
            V = xi.nu21.shape[0]
            bound = roofline.volume_em_bound(Z, V, N)
            ms_p = statistics.median(plain)
            log(f"volume_em {label} on {card}: kernel {kernel_ms:.4f} ms on "
                f"the device alone, bound {bound['bound_ms']:.6f} ms by "
                f"{bound['bound_by']} (the benchmark's model: {bound['ops']} "
                f"operations, {bound['bytes']} bytes; {Z} zones x {V} x {N}), "
                f"{100 * bound['bound_ms'] / kernel_ms:.4f}% of it; the plain "
                f"version {ms_p:.3f} ms (median of {VE_TURNS}: "
                f"{['%.3f' % t for t in plain]}); terms skipped "
                f"{100 * sum(c.skipped):.2f}%")
            entries.append({
                "name": f"volume_em_kernel.{label.replace(' ', '_')}",
                "route": "cuda",
                "source": "compton2d_tpu_torch/csrc/volume_em.cu",
                "replaces": None, "library_ms": None,
                "launches": launches if label == cell else 0,
                "j_gap": c.j_gap, "k_gap": c.k_gap, "gap_limit": c.limit,
                "skipped_share": sum(c.skipped), "ms": kernel_ms,
                "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
                "plain_ms": ms_p})
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = bench.card_line("cuda")
    log(card)   # name, power limit: nvidia-smi's own line
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    build_s = flight.build()
    log(f"built {kernel_build.library_path(flight._SOURCE).name} in "
        f"{build_s:.2f} s")
    log(flight.ptxas_report())
    build_s = update.build()
    log(f"built {kernel_build.library_path(update._SOURCE).name} in "
        f"{build_s:.2f} s")
    build_s = emissivity.build()
    log(f"built {kernel_build.library_path(emissivity._SOURCE).name} in "
        f"{build_s:.2f} s")

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    select = kernel_only()
    k_inline = phase_kernel(device, "kernel", NZ, NR, True, 256)
    k_strat = phase_kernel(device, "strat kernel", MRK_NZ, MRK_NR, False,
                           512)
    k_pairs = phase_kernel(device, "pair kernel", PAIR_NZ, PAIR_NR, True,
                           256, pairs=True, n=PAIR_SLOTS, n_vol=PAIR_VOL,
                           num_nt=PAIR_NT, n_gg=PAIR_GG)
    k_pairs_strat = phase_kernel(device, "strat pair kernel", PAIR_NZ,
                                 PAIR_NR, False, 256, pairs=True,
                                 n=PAIR_SLOTS, n_vol=PAIR_VOL,
                                 num_nt=PAIR_NT, n_gg=PAIR_GG)
    k_window = phase_kernel(device, "windowed kernel", LARGE_NZ, LARGE_NR,
                            True, 256, placement="global", n=LARGE_SLOTS)
    k_global = phase_kernel(device, "global-table kernel", RESIDENT_NZ,
                            RESIDENT_NR, True, 256, placement="global")
    launches_inline = phase_main_path(device, card)
    launches_strat = phase_mrk421(device, card)
    launches_pairs, launches_pairs_strat = phase_pairs(device, card)
    launches_window, launches_global = phase_large(device, card)
    launches_disk, launches_ec, k_ec = phase_decks(device, card)
    launches_prod, k_prod = phase_production(device, card)
    log(f"Coulomb kernel entry: {json.dumps(k_prod)}")
    launches_ranks, k_ranks = phase_ranks(device, card)
    log(f"two-rank kernel entry: {json.dumps(k_ranks)}")
    launches_gate, gates = phase_gate(device, card)
    launches_dryrun = phase_entry_points(device, card, gates)
    launches_loop_phase = phase_loop(device, card, select)
    k_fp = phase_fp(device, card)
    k_ve = phase_volume_em(device, card)

    replaces = "compton2d_tpu/transport/flight_pallas2.py:347"
    log(json.dumps({"kernels": [
        {"name": "flight_kernel", "route": "cuda",
         "source": "compton2d_tpu_torch/csrc/flight.cu",
         "replaces": replaces,
         "launches": (launches_inline + launches_disk + launches_prod
                      + launches_ranks + launches_gate["main_path"]
                      + launches_loop_phase),
         "library_ms": None, **k_inline},
        {"name": "flight_kernel_strat", "route": "cuda",
         "source": "compton2d_tpu_torch/csrc/flight.cu",
         "replaces": replaces, "launches": launches_strat,
         "library_ms": None, **k_strat},
        {"name": "flight_kernel_pairs", "route": "cuda",
         "source": "compton2d_tpu_torch/csrc/flight.cu",
         "replaces": replaces,
         "launches": (launches_pairs + launches_gate["pair_corona"]
                      + launches_dryrun),
         "library_ms": None, **k_pairs},
        {"name": "flight_kernel_pairs_strat", "route": "cuda",
         "source": "compton2d_tpu_torch/csrc/flight.cu",
         "replaces": replaces,
         "launches": (launches_pairs_strat
                      + launches_gate["pair_corona_strat"]),
         "library_ms": None, **k_pairs_strat},
        {"name": "flight_kernel_windowed", "route": "cuda",
         "source": "compton2d_tpu_torch/csrc/flight.cu",
         "replaces": replaces,
         "launches": launches_window + launches_gate["grid_40x30"],
         "library_ms": None, **k_window},
        {"name": "flight_kernel_global_tables", "route": "cuda",
         "source": "compton2d_tpu_torch/csrc/flight.cu",
         "replaces": replaces, "launches": launches_global,
         "library_ms": None, **k_global},
        {"name": "flight_kernel_global_tables_10x5", "route": "cuda",
         "source": "compton2d_tpu_torch/csrc/flight.cu",
         "replaces": replaces, "launches": launches_ec,
         "library_ms": None, **k_ec},
        *k_fp,
        *k_ve,
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
