"""The port against the reference's Pallas kernel at bench size.

The counterpart of ``tools/pallas_e2e.py``: K seed replicates a side of
one configuration (a *cell*), the same physics channels of each
replicate, and the same test of the pooled means. Here one side is the
port on the card and the other the JAX package running its Pallas flight
kernel (interpreted on the CPU). The port imports no JAX, so the
reference side runs once, ahead of time, and its replicates are read
from the committed ``data/gate_reference.json``
(``tests/gate_reference.py`` writes it); the card side runs in
``chip_smoke.py``'s phase 10. The reference side runs with the port's
two repairs of the reference's Fokker-Planck solve patched in (the
Chang-Cooper limit below w = -500, no pair terms in the two end bins;
the JSON lists them under ``reference_repairs``): in the pair corona
they set the zones' temperatures by the disk, where the unrepaired
reference's heated zones lose their positrons.

The test (``gate``) is ``run_gate``'s, key for key: each scalar channel
passes with z < CAL_MULT on the difference of the means or a deviation
below REL_FLOOR; the angle-summed escaping spectrum against the
reference's split-half noise; the zone temperatures zone by zone, the
zones whose relative seed spread is at least STIFF_SIGMA counted as
stiff. The "pallas" side of ``run_gate``'s keys is the port, the "xla"
side the reference.

Cells (``CELLS``: ``small_corona``'s arguments):

- ``main_path``: the bench corona, 8x4 zones, 131072 slots, nst 60000,
  the flight kernel's B1 mode with its tables in shared memory;
- ``pair_corona``: ``tools/pallas_e2e._build`` exactly (4x3 zones,
  262144 slots, nst 200000, pair_switch, a bounded tail gamma 3-20), B2;
- ``pair_corona_strat``: ``tools/pallas_e2e._build(strat=True)``, the
  pair corona with stratified tail splitting (``CELL_SOURCE``), B2 with
  B3;
- ``grid_40x30``: the reference's windowed-test grid at the main path's
  widths and slots, B4 after the zone sort.

``tracker_gate`` is ``tools/pallas_e2e.py``'s own comparison, the flight
kernel against the lock-step loop, with both sides run by the port in one
process (the ``tracker_main`` cell: ``main_path`` with
``pallas_tracking`` "on" against "off"): the loop side takes the
reference's place (pallas_e2e's "xla" side), its floors pass through
``choose_statistic``, and no committed JSON is read.

``small_corona``'s keywords reach only the physics configuration, so a
cell's source settings stand apart, in ``CELL_SOURCE``, and
``cell_config`` applies them.

A *statistic* says what a replicate measures (``STATISTICS``): with
``census_rr_off`` the census roulette is off and the scalars are those
of the last step, the spectrum summed over all steps, as ``_run_seed``
sums it; with ``post_transient`` the roulette stays on and the scalars
and the spectrum are those of the last of the steps only. Each cell's
statistic and steps are the ones ``choose_statistic`` picks from the
reference's measured floors.

The JSON may also hold cells that are not gated (``"gated": false``):
``pair_corona_unrepaired`` is the pair corona's reference without the
two repairs, the run the port's card side failed against (its disk-row
zone temperatures), kept as the witness of that finding.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Optional

import numpy as np
import torch

from compton2d_tpu_torch.examples import small_corona

CAL_MULT = 4.0     # z-score threshold on the pooled means
REL_FLOOR = 0.01   # deviations below 1 % always pass
STIFF_SIGMA = 0.05  # zones with >5 % seed spread are "stiff"
FLOOR_TARGET = 0.05  # the noise floor a statistic is chosen to reach

SCALARS = ("escaped", "census", "edep_total", "scatter_gain", "pair_abs",
           "te_mean")
K_SEEDS = 12
# replicate i runs seed REF_SEED + 13 i on the reference side (the Pallas
# side's seeds of run_gate) and PORT_SEED + 13 i on the port
REF_SEED, PORT_SEED = 3, 3 + 977

_BENCH = dict(num_nt=200, n_vol=400, nphfield=400, t_const=False,
              max_flight_iters=256, seed=0)
_PAIRS = dict(nz=4, nr=3, nst=200000, n_slots=1 << 18, num_nt=100,
              n_vol=128, nphfield=128, t_const=False, seed=0,
              pair_switch=True, amxwl=0.5, gmin=3.0, gmax=20.0, p_nth=2.5)
CELLS = {
    "main_path": dict(nz=8, nr=4, nst=60000, n_slots=1 << 17, **_BENCH),
    "pair_corona": _PAIRS,
    "pair_corona_strat": _PAIRS,
    "grid_40x30": dict(nz=40, nr=30, nst=60000, n_slots=1 << 17, **_BENCH),
}
# SourceConfig fields a cell sets beside small_corona's: the tail
# boundary sits inside the gamma <= 20 population, so the split fires
CELL_SOURCE = {
    "pair_corona_strat": dict(strat_split=True, strat_gamma_c=10.0,
                              strat_p_max=0.5),
}
# the flight kernel's mode on each cell's path
CELL_MODE = {"main_path": "B1", "pair_corona": "B2",
             "pair_corona_strat": "B2+B3", "grid_40x30": "B4"}
STATISTICS = ("census_rr_off", "post_transient")

REFERENCE_JSON = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "data", "gate_reference.json")


def cell_config(cfg, statistic: str, cell: Optional[str] = None):
    """``cfg`` under ``statistic``, with ``pallas_tracking="on"`` (the
    reference's Pallas kernel, the port's flight kernel) and ``cell``'s
    ``CELL_SOURCE`` settings. Works on either package's SimConfig."""
    if statistic not in STATISTICS:
        raise ValueError(f"unknown statistic {statistic!r}")
    run = dataclasses.replace(cfg.run, pallas_tracking="on")
    if statistic == "census_rr_off":
        run = dataclasses.replace(run, census_rr=False)
    source = dataclasses.replace(cfg.source, **CELL_SOURCE.get(cell, {}))
    return dataclasses.replace(cfg, run=run, source=source)


def _plain(v):
    """JSON data of a config value; an array of one value is that value."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, np.ndarray):
        flat = v.reshape(-1)
        if flat.size and np.all(flat == flat[0]):
            return flat[0].item()
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    return v


def config_record(sim) -> dict:
    """The cell's configuration as JSON data: the SimConfig and the zone
    initialisation, as dicts. Works on either package's Simulation."""
    return json.loads(json.dumps({
        "config": _plain(dataclasses.asdict(sim.cfg)),
        "zone_init": _plain(dataclasses.asdict(sim.zone_init)),
    }))


def build_cell(cell: str, statistic: str, device="cuda"):
    """The port's Simulation of ``cell`` under ``statistic``."""
    sim = small_corona(**CELLS[cell], device=device)
    return sim.with_config(cell_config(sim.cfg, statistic, cell))


def _fresh(obj):
    """A copy of a (nested) state whose tensors are clones."""
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if hasattr(obj, "_fields"):
        return type(obj)(*(_fresh(getattr(obj, f)) for f in obj._fields))
    return obj


def replicate_channels(sim, state0, seed: int, steps: int,
                       tally_from: int = 0) -> dict:
    """One replicate (``_run_seed``'s counterpart): ``sim`` restarts from
    ``state0`` (its tensors cloned, so the tables and the initial state
    are built once for every replicate) with a generator seeded by
    ``seed``, runs ``steps`` steps and returns :func:`channels` of the
    last, with the escaping spectrum summed over the steps from
    ``tally_from`` on."""
    gen = torch.Generator(device=state0.key.device)
    gen.manual_seed(int(seed))
    sim.state = _fresh(state0)._replace(key=gen)
    fout, balances = None, []
    for i in range(steps):
        out = sim.step()
        balances.append(sim.energy_audit()["balance"])
        if i >= tally_from:
            f = out.tallies.fout.cpu().numpy()
            fout = f if fout is None else fout + f
    return channels(sim, fout, balances)


def port_replicates(sim, ref: dict) -> list:
    """The port's side of a gate cell: from ``sim``'s state, one replicate
    (:func:`replicate_channels`) a seed of the reference cell ``ref``,
    each of its recorded steps."""
    state0 = sim.state
    return [replicate_channels(sim, state0, PORT_SEED + 13 * i,
                               ref["steps"], ref["tally_from"])
            for i in range(len(ref["seeds"]))]


def channels(sim, fout: np.ndarray, balances: list) -> dict:
    """``_run_seed``'s channels of ``sim``'s last step: the audit's
    scalars, the summed |edep|, the mean Te, the worst |balance - 1| of
    ``balances``, the per-zone Te and the escaping spectrum ``fout``
    (angle by energy); and, for the logs, the source energy lost to full
    slots."""
    audit = sim.energy_audit()
    t = sim.last_outputs.tallies
    edep = t.edep.cpu().numpy()
    tea = sim.state.zones.tea.cpu().numpy()
    return {
        "finite": bool(
            np.all(np.isfinite(edep))
            and np.all(np.isfinite(t.prdep.cpu().numpy()))
            and np.all(np.isfinite(t.ecens.cpu().numpy()))
            and np.all(np.isfinite(fout))
            and math.isfinite(float(t.e_killed))),
        "escaped": float(audit["escaped"]),
        "census": float(audit["census"]),
        "edep_total": float(np.abs(edep).sum()),
        "scatter_gain": float(audit["scatter_gain"]),
        "pair_abs": float(audit["pair_abs"]),
        "te_mean": float(np.mean(tea)),
        "balance_worst": float(max(abs(b - 1.0) for b in balances)),
        "fout": fout,
        "te": np.asarray(tea, np.float64),
        "src_lost": float(audit["src_lost"]),
    }


def z_test(a, b) -> tuple:
    """``run_gate``'s test of one scalar channel, side ``a`` against side
    ``b``: (relative deviation of the means, the relative 1-sigma error
    of their difference, passed)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    ref = max(abs(b.mean()), abs(a.mean()), 1e-300)
    dev = abs(a.mean() - b.mean()) / ref
    sig = math.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b)) / ref
    return dev, sig, bool((dev < CAL_MULT * sig) or (dev < REL_FLOOR))


def spec_dev(a: np.ndarray, b: np.ndarray) -> float:
    """``_spec_dev`` on angle-summed spectra: the median per-bin relative
    deviation over bins carrying significant flux."""
    big = (a + b) > 0.02 * (a + b).max()
    if not big.any():
        return 1.0
    return float(np.median(
        np.abs(a[big] - b[big]) / np.maximum(a[big] + b[big], 1e-300)))


def pooled_spectra(reps: list) -> dict:
    """The angle-summed spectrum pooled over the replicates and over each
    half of them (the split-half noise), as the reference side stores
    them."""
    h = len(reps) // 2

    def pool(rs):
        return np.sum([r["fout"] for r in rs], axis=0).sum(0)

    return {"pooled": pool(reps), "half1": pool(reps[:h]),
            "half2": pool(reps[h:])}


def _ref_arrays(ref: dict):
    dtype = np.dtype(ref["spectrum"]["dtype"])
    spec = {k: np.asarray(ref["spectrum"][k], dtype)
            for k in ("pooled", "half1", "half2")}
    te = np.stack([np.asarray(r["te"], np.float64)
                   for r in ref["replicates"]])
    return spec, te


def gate(port_reps: list, ref: dict, ndigits: Optional[int] = 5) -> dict:
    """``run_gate``'s dict, key for key, for the port's replicates
    (``replicate_channels``) against a cell of the reference JSON; its
    deviations and floors rounded to ``ndigits`` as ``run_gate`` rounds
    them (None: unrounded, for logs; the checks do not depend on it)."""
    reps_x = ref["replicates"]
    K = len(port_reps)
    if K != len(reps_x):
        raise ValueError(f"{K} port replicates against {len(reps_x)}")
    checks = {
        "finite": all(r["finite"] for r in port_reps + reps_x),
        "audit_pallas": max(r["balance_worst"] for r in port_reps) < 5e-3,
        "audit_xla": max(r["balance_worst"] for r in reps_x) < 5e-3,
    }
    rel, floor = {}, {}
    for q in SCALARS:
        dev, sig, ok = z_test([r[q] for r in port_reps],
                              [r[q] for r in reps_x])
        rel[q], floor[q] = dev, sig
        checks[f"rel_{q}"] = ok

    spec, te_x = _ref_arrays(ref)
    f_p = np.sum([r["fout"] for r in port_reps], axis=0).sum(0)
    dev_sp = spec_dev(f_p, spec["pooled"])
    noise_sp = spec_dev(spec["half1"], spec["half2"]) / math.sqrt(2.0)
    rel["spectrum"], floor["spectrum"] = dev_sp, noise_sp
    checks["spectrum"] = dev_sp < max(CAL_MULT * noise_sp, REL_FLOOR)

    te_p = np.stack([r["te"] for r in port_reps])
    mp, mx = te_p.mean(0), te_x.mean(0)
    sig_z = np.sqrt(te_p.var(0, ddof=1) / K + te_x.var(0, ddof=1) / K)
    ref_z = np.maximum(np.abs(mx), 1.0)
    dev_z = np.abs(mp - mx) / ref_z
    sig_rel_z = sig_z / ref_z
    stiff = np.sqrt(te_x.var(0, ddof=1)) / ref_z >= STIFF_SIGMA
    ok_z = (dev_z < CAL_MULT * np.maximum(sig_rel_z, 1e-12)) | (
        dev_z < 0.02)
    nonstiff_dev = float(dev_z[~stiff].max()) if (~stiff).any() else 0.0
    rel["te_nonstiff"] = nonstiff_dev
    floor["te_nonstiff"] = (float(sig_rel_z[~stiff].max())
                            if (~stiff).any() else 0.0)
    rel["te_worst_zone"] = float(dev_z.max())
    floor["te_worst_zone"] = float(sig_rel_z.max())
    checks["te_zones"] = bool(ok_z.all())
    checks["te_nonstiff"] = nonstiff_dev < max(
        CAL_MULT * floor["te_nonstiff"], 0.02)

    return {
        "passed": bool(all(checks.values())),
        "cal_mult": CAL_MULT,
        "steps": ref["steps"],
        "nst": ref["config"]["source"]["nst"],
        "n_seeds": K,
        "pairs": bool(ref["config"]["physics"]["pair_switch"]),
        "strat": bool(ref["config"]["source"]["strat_split"]),
        "n_stiff_zones": int(stiff.sum()),
        "balance_pallas_worst": max(r["balance_worst"] for r in port_reps),
        "balance_xla_worst": max(r["balance_worst"] for r in reps_x),
        "rel_dev": {k: round(v, ndigits) if ndigits is not None else v
                    for k, v in rel.items()},
        "noise_floor": {k: round(v, ndigits) if ndigits is not None else v
                        for k, v in floor.items()},
        "checks": {k: bool(v) for k, v in checks.items()},
    }


def ref_floors(ref: dict) -> dict:
    """The noise floors the gate would have with a port side as noisy as
    the reference's replicates: sqrt(2 var / K) / |mean| per scalar; the
    spectrum's split-half floor; the zones' worst relative floor."""
    reps = ref["replicates"]
    K = len(reps)
    out = {}
    for q in SCALARS:
        b = np.asarray([r[q] for r in reps], np.float64)
        out[q] = math.sqrt(2.0 * b.var(ddof=1) / K) / max(abs(b.mean()),
                                                          1e-300)
    spec, te = _ref_arrays(ref)
    out["spectrum"] = spec_dev(spec["half1"], spec["half2"]) / math.sqrt(2)
    ref_z = np.maximum(np.abs(te.mean(0)), 1.0)
    out["te_worst_zone"] = float(
        (np.sqrt(2.0 * te.var(0, ddof=1) / K) / ref_z).max())
    return out


def choose_statistic(floors_by_statistic: list) -> tuple:
    """The (statistic, steps) a cell is gated with, from the reference's
    floors of each run (``{"statistic", "steps", "floors"}``). Only runs
    of two steps or more count: a first step's tallies follow no
    Fokker-Planck update and no census pair field. Of those, the census
    roulette kept (``post_transient``, the path as it runs) wins when
    every scalar floor is at or below FLOOR_TARGET; otherwise the most
    scalar floors at or below it, ties going to the lower worst scalar
    floor."""
    def n_ok(c):
        return sum(c["floors"][q] <= FLOOR_TARGET for q in SCALARS)

    def worst(c):
        return max(c["floors"][q] for q in SCALARS)

    runs = [c for c in floors_by_statistic if c["steps"] >= 2]
    if not runs:
        raise ValueError("no run of two steps or more")
    kept = [c for c in runs if c["statistic"] == "post_transient"
            and n_ok(c) == len(SCALARS)]
    best = (min(kept, key=worst) if kept
            else max(runs, key=lambda c: (n_ok(c), -worst(c))))
    return best["statistic"], best["steps"]


def load_reference(path: Optional[str] = None) -> dict:
    with open(path or REFERENCE_JSON) as f:
        return json.load(f)


def _dotted(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_dotted(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def check_config(sim, ref_cell: dict) -> list:
    """The dotted names (``config.run.census_rr``, ``zone_init.tea``) of
    every configuration field of ``sim`` that differs from the reference
    cell's recorded one."""
    mine = _dotted(config_record(sim))
    theirs = _dotted({k: ref_cell[k] for k in ("config", "zone_init")})
    return [k for k in sorted(set(mine) | set(theirs))
            if mine.get(k, KeyError) != theirs.get(k, KeyError)]


# the tracker_main cell: main_path's configuration and statistic, the
# kernel against the loop
TRACKER_CELL = "main_path"
TRACKER_STATISTIC, TRACKER_STEPS = "post_transient", 4


def side_record(sim, reps: list, seeds: list, statistic: str, steps: int,
                tally_from: int) -> dict:
    """One side's replicates (``replicate_channels``) in the layout of a
    reference JSON cell, so that ``gate`` and ``ref_floors`` read it: the
    configuration, the statistic, the replicates and the pooled spectrum,
    with its floors."""
    spec = pooled_spectra(reps)
    rec = {
        **config_record(sim),
        "statistic": statistic, "steps": steps, "tally_from": tally_from,
        "seeds": list(seeds),
        "replicates": [{k: r[k] for k in ("finite", "balance_worst",
                                          "src_lost", "te", *SCALARS)}
                       for r in reps],
        "spectrum": {"dtype": str(spec["pooled"].dtype), **spec},
    }
    rec["floors"] = ref_floors(rec)
    return rec


def tracker_gate(device="cuda", cell_kw: Optional[dict] = None,
                 k: int = K_SEEDS, steps: int = TRACKER_STEPS) -> dict:
    """``tools/pallas_e2e.py``'s comparison in the port: ``cell_kw``
    (``small_corona``'s arguments; ``CELLS[TRACKER_CELL]`` by default)
    under TRACKER_STATISTIC with ``pallas_tracking`` "on" (the flight
    kernel, pallas_e2e's "pallas" side, seeds PORT_SEED + 13 i) and "off"
    (the lock-step loop, its "xla" side, seeds REF_SEED + 13 i), k
    replicates of ``steps`` steps each. Returns the gate dict of the
    kernel against the loop (``gate``), the statistic and steps that
    ``choose_statistic`` takes from the loop side's floors, whether every
    scalar floor is at or below FLOOR_TARGET, and both sides' trackers
    and mean Te."""
    kernel = small_corona(**(cell_kw or CELLS[TRACKER_CELL]), device=device)
    kernel = kernel.with_config(cell_config(kernel.cfg, TRACKER_STATISTIC))
    loop = kernel.with_config(dataclasses.replace(
        kernel.cfg, run=dataclasses.replace(kernel.cfg.run,
                                            pallas_tracking="off")))
    tally_from = steps - 1
    reps = {}
    for name, sim, seed0 in (("loop", loop, REF_SEED),
                             ("kernel", kernel, PORT_SEED)):
        state0 = sim.state
        reps[name] = [replicate_channels(sim, state0, seed0 + 13 * i, steps,
                                         tally_from) for i in range(k)]
    ref = side_record(loop, reps["loop"],
                      [REF_SEED + 13 * i for i in range(k)],
                      TRACKER_STATISTIC, steps, tally_from)
    floors = ref["floors"]
    chosen = choose_statistic([{"statistic": TRACKER_STATISTIC,
                                "steps": steps, "floors": floors}])
    return {
        "gate": gate(reps["kernel"], ref),
        "statistic": chosen,
        "floors_ok": all(floors[q] <= FLOOR_TARGET for q in SCALARS),
        "floors": floors,
        "trackers": {"kernel": kernel.tracker, "loop": loop.tracker},
        "te_mean": {n: float(np.mean([x["te_mean"] for x in r]))
                    for n, r in reps.items()},
    }
