"""The reference side of the port's bench-size gate, on the CPU.

A script, not a test file (pytest collects only ``test_*.py``). It runs
each cell of ``compton2d_tpu_torch.e2e_gate.CELLS`` in the JAX package
with ``pallas_tracking="on"`` (the reference's Pallas flight kernel,
interpreted on the CPU), K seed replicates of ``--steps`` steps under
``--statistic``, and writes the cell into
``compton2d_tpu_torch/data/gate_reference.json`` (the other cells kept):
the configuration, the steps, the statistic and the seeds, each
replicate's scalars and per-zone Te, the pooled angle-summed escaping
spectrum and its two split halves, the noise floors the gate would have
with a port side as noisy (``e2e_gate.ref_floors``), the JAX version,
the commit and the CPU seconds. ``chip_smoke.py``'s phase 10 holds the
port on the card against it.

Run from the repository root, one cell at a time. ``--out PATH`` writes
elsewhere, to measure a statistic's floors without touching the
committed file; ``--probe PATH`` (repeatable) names such a file holding
the same cell under another statistic or number of steps. The written
cell records every run's floors under ``floors_by_statistic``, and its
own statistic and steps must be the ones
``e2e_gate.choose_statistic`` picks from them (a test checks it)::

    JAX_PLATFORMS=cpu python tests/gate_reference.py main_path \
        --statistic census_rr_off --steps 4 --out /tmp/main_off.json
    JAX_PLATFORMS=cpu python tests/gate_reference.py main_path \
        --statistic post_transient --steps 4 --probe /tmp/main_off.json

The reference runs with the port's two repairs of its Fokker-Planck
solve patched in (``patch_repairs``). ``--no-repairs`` runs it as it is
and writes the cell as ``<cell>_unrepaired``, not gated.
"""
import argparse
import json
import math
import os
import subprocess
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from compton2d_tpu import examples as jex  # noqa: E402
from compton2d_tpu_torch import e2e_gate  # noqa: E402


def patch_repairs():
    """The port's two repairs of the reference's Fokker-Planck solve,
    patched into the JAX package before its step is traced (ROADMAP §C):
    the Chang-Cooper weight's limit -w below w = -500, and
    no pair source or sink in the two end bins of the Lorentz-factor
    grid. Returns their names."""
    import compton2d_tpu.driver as jdriver
    import compton2d_tpu.fp.chang_cooper as jcc
    from compare_pairs import port_cc_limit

    jcc._w_over_expm1 = port_cc_limit
    fp_step = jdriver.fp_step

    def fp_step_without_end_bins(*a, **k):
        for name in ("dn_pp", "dne_pa", "dnp_pa"):
            if k.get(name) is not None:
                k[name] = k[name].at[..., 0].set(0.0).at[..., -1].set(0.0)
        return fp_step(*a, **k)

    jdriver.fp_step = fp_step_without_end_bins
    return ["chang_cooper_limit_below_w_-500", "no_pair_terms_in_end_bins"]


def build(cell: str, statistic: str):
    sim = jex.small_corona(**e2e_gate.CELLS[cell])
    return sim.with_config(e2e_gate.cell_config(sim.cfg, statistic, cell))


def run_seed(sim, state0, seed: int, steps: int, tally_from: int) -> dict:
    """``tools/pallas_e2e._run_seed`` with the spectrum summed over the
    steps from ``tally_from`` on (``e2e_gate.replicate_channels``'s
    counterpart)."""
    sim._state = state0._replace(key=jax.random.PRNGKey(seed))
    sim._clock_dirty = True
    fout, balances = None, []
    for i in range(steps):
        out = sim.step()
        balances.append(sim.energy_audit()["balance"])
        if i >= tally_from:
            f = np.asarray(out.tallies.fout)
            fout = f if fout is None else fout + f
    audit = sim.energy_audit()
    t = out.tallies
    return {
        "finite": bool(
            np.all(np.isfinite(np.asarray(t.edep)))
            and np.all(np.isfinite(np.asarray(t.prdep)))
            and np.all(np.isfinite(np.asarray(t.ecens)))
            and np.all(np.isfinite(fout))
            and math.isfinite(float(t.e_killed))),
        "escaped": float(audit["escaped"]),
        "census": float(audit["census"]),
        "edep_total": float(np.abs(np.asarray(t.edep)).sum()),
        "scatter_gain": float(audit["scatter_gain"]),
        "pair_abs": float(audit["pair_abs"]),
        "te_mean": float(np.mean(np.asarray(sim.state.zones.tea))),
        "balance_worst": float(max(abs(b - 1.0) for b in balances)),
        "fout": fout,
        "te": np.asarray(sim.state.zones.tea, np.float64),
        "balances": [float(b) for b in balances],
        "src_lost": float(audit["src_lost"]),
    }


def short(x) -> float:
    """A float32 value as the shortest decimal that reads back to it."""
    return float(repr(np.float32(x)).split("(")[-1].rstrip(")"))


def commit() -> str:
    try:
        head = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO,
                              capture_output=True, text=True,
                              check=True).stdout.strip()
        dirty = subprocess.run(["git", "status", "--porcelain", "--",
                                "compton2d_tpu", "tools"], cwd=REPO,
                               capture_output=True, text=True).stdout.strip()
        return head + ("-dirty" if dirty else "")
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def run_cell(cell: str, statistic: str, steps: int, seeds: int,
             tally_from: int) -> dict:
    cpu0, wall0 = time.process_time(), time.perf_counter()
    sim = build(cell, statistic)
    state0 = sim.state
    seed_list = [e2e_gate.REF_SEED + 13 * i for i in range(seeds)]
    reps = []
    for s in seed_list:
        w0 = time.perf_counter()
        r = run_seed(sim, state0, s, steps, tally_from)
        reps.append(r)
        print(f"{cell} seed {s}: {time.perf_counter() - w0:.2f} s, "
              f"balances {r['balances']}, te_mean {r['te_mean']:.4f}, "
              f"escaped {r['escaped']:.6e}, census {r['census']:.6e}, "
              f"src_lost {r['src_lost']:.3e}", flush=True)
    spec = e2e_gate.pooled_spectra(reps)
    entry = {
        **e2e_gate.config_record(sim),
        "cell": cell,
        "mode": e2e_gate.CELL_MODE[cell],
        "statistic": statistic,
        "steps": steps,
        "tally_from": tally_from,
        "seeds": seed_list,
        "replicates": [
            {**{k: r[k] for k in ("finite", "balance_worst", "src_lost",
                                  *e2e_gate.SCALARS)},
             "te": [[short(v) for v in row] for row in r["te"]]}
            for r in reps],
        "spectrum": {"dtype": str(spec["pooled"].dtype),
                     **{k: [short(v) for v in a] for k, a in spec.items()}},
        "jax_version": jax.__version__,
        "jax_backend": jax.default_backend(),
        "commit": commit(),
        "cpu_seconds": time.process_time() - cpu0,
        "wall_seconds": time.perf_counter() - wall0,
        "cpu_count": os.cpu_count(),
    }
    entry["floors"] = e2e_gate.ref_floors(entry)
    return entry


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cell", choices=sorted(e2e_gate.CELLS))
    ap.add_argument("--statistic", choices=e2e_gate.STATISTICS,
                    default="census_rr_off")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--no-repairs", dest="repairs", action="store_false",
                    help="run the reference as it is, without the port's "
                    "two repairs of its Fokker-Planck solve (the gate's "
                    "reference has them, patch_repairs)")
    ap.add_argument("--out", default=e2e_gate.REFERENCE_JSON)
    ap.add_argument("--probe", action="append", default=[],
                    help="a JSON of this script's holding the cell under "
                    "another statistic, whose floors are recorded too")
    args = ap.parse_args()
    # census_rr_off sums the spectrum over every step (as _run_seed
    # does); post_transient reads the last step alone
    tally_from = 0 if args.statistic == "census_rr_off" else args.steps - 1
    repairs = patch_repairs() if args.repairs else []
    entry = run_cell(args.cell, args.statistic, args.steps,
                     e2e_gate.K_SEEDS, tally_from)
    entry["reference_repairs"] = repairs
    entry["gated"] = args.repairs
    entry["floors_by_statistic"] = [
        {k: entry[k] for k in ("statistic", "steps", "floors")}]
    for path in args.probe:
        with open(path) as f:
            other = json.load(f)[args.cell]
        entry["floors_by_statistic"].append(
            {k: other[k] for k in ("statistic", "steps", "floors")})
    chosen = e2e_gate.choose_statistic(entry["floors_by_statistic"])
    data = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            data = json.load(f)
    data[args.cell if args.repairs else f"{args.cell}_unrepaired"] = entry
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(data, f, separators=(",", ":"))
        f.write("\n")
    print(json.dumps({"cell": args.cell, "statistic": args.statistic,
                      "steps": args.steps, "chosen_of_the_runs": chosen,
                      "floors": entry["floors"],
                      "above_target": sorted(
                          q for q, v in entry["floors"].items()
                          if v > e2e_gate.FLOOR_TARGET),
                      "cpu_seconds": entry["cpu_seconds"],
                      "wall_seconds": entry["wall_seconds"]}, indent=1))


if __name__ == "__main__":
    main()
