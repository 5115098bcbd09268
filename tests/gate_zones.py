"""A gate cell's zones over many seeds, port against reference.

A script, not a test file (pytest collects only ``test_*.py``). It runs a
cell of ``compton2d_tpu_torch.e2e_gate`` under the statistic and steps
that the committed reference JSON records, for ``--seeds`` seeds, and
writes each seed's per-zone temperature, Compton deposit (``edep``) and
census photon count (``npcen``) of the last step to ``--out``. The
reference side (``--side jax``) runs the JAX package's Pallas kernel in
interpret mode on the CPU with the port's two FP repairs patched in, as
``tests/gate_reference.py`` does; the port side (``--side port``) runs
on the card unless ``--device cpu`` is given, and imports no JAX.
``--compare REF PORT`` then sets the two files side by side: for each
zone of the first ``--rows`` rows the mean temperature, census count and
deposit with ``e2e_gate.z_test``, and, with a two-sided Fisher exact
test, the share of seeds with no census photon in the zone and the share
whose temperature lies in the upper half of the two sides' pooled range
(a zone at the edge of the photons' reach takes one of two temperatures,
cooled or not)::

  JAX_PLATFORMS=cpu python tests/gate_zones.py --side jax \\
      --cell grid_40x30 --seeds 48 --out /tmp/ref.json
  python tests/gate_zones.py --side port --cell grid_40x30 --seeds 48 \\
      --out /tmp/port.json
  python tests/gate_zones.py --compare /tmp/ref.json /tmp/port.json
"""
import argparse
import json
import math
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import numpy as np  # noqa: E402

from compton2d_tpu_torch import e2e_gate  # noqa: E402

FIELDS = ("te", "edep", "npcen")


def _record(te, edep, npcen) -> dict:
    return {f: np.asarray(a, np.float64).tolist()
            for f, a in zip(FIELDS, (te, edep, npcen))}


def run_jax(cell: str, rc: dict, seeds: list) -> list:
    import gate_reference as gr
    import jax

    gr.patch_repairs()
    sim = gr.build(cell, rc["statistic"])
    state0 = sim.state
    rows = []
    for s in seeds:
        sim._state = state0._replace(key=jax.random.PRNGKey(s))
        sim._clock_dirty = True
        for _ in range(rc["steps"]):
            out = sim.step()
        t = out.tallies
        rows.append(_record(sim.state.zones.tea, t.edep, t.npcen))
        print(f"{cell} jax seed {s}: te row 1 "
              f"{np.round(rows[-1]['te'][1][:4], 3)}", flush=True)
    return rows


def run_port(cell: str, rc: dict, seeds: list, device: str) -> list:
    import torch

    sim = e2e_gate.build_cell(cell, rc["statistic"], device)
    bad = e2e_gate.check_config(sim, rc)
    if bad:
        raise SystemExit(f"{cell}: config differs from the reference's in "
                         f"{bad}")
    state0 = sim.state
    rows = []
    for s in seeds:
        gen = torch.Generator(device=state0.key.device)
        gen.manual_seed(int(s))
        sim.state = e2e_gate._fresh(state0)._replace(key=gen)
        for _ in range(rc["steps"]):
            out = sim.step()
        t = out.tallies
        rows.append(_record(sim.state.zones.tea.cpu(), t.edep.cpu(),
                            t.npcen.cpu()))
        print(f"{cell} port seed {s}: te row 1 "
              f"{np.round(rows[-1]['te'][1][:4], 3)}", flush=True)
    return rows


def fisher_two_sided(a: int, n1: int, b: int, n2: int) -> float:
    """P of a table as or less likely than a of n1 against b of n2, with
    the margins fixed."""
    k = a + b
    n = n1 + n2

    def p(x):
        return math.comb(n1, x) * math.comb(n2, k - x) / math.comb(n, k)

    p0 = p(a)
    lo, hi = max(0, k - n2), min(k, n1)
    return min(1.0, sum(p(x) for x in range(lo, hi + 1)
                        if p(x) <= p0 * (1 + 1e-9)))


def compare(ref: dict, port: dict, rows: int) -> list:
    out = []
    arr = {side: {f: np.asarray([r[f] for r in d["replicates"]])
                  for f in FIELDS} for side, d in (("ref", ref),
                                                   ("port", port))}
    nr = arr["ref"]["te"].shape[2]
    for j in range(rows):
        for i in range(nr):
            row = {"zone": [j, i]}
            for f in FIELDS:
                a, b = arr["port"][f][:, j, i], arr["ref"][f][:, j, i]
                dev, sig, ok = e2e_gate.z_test(a, b)
                row[f] = {"port": float(a.mean()), "ref": float(b.mean()),
                          "z": dev / sig if sig > 0 else None, "pass": ok}
            te_p, te_r = arr["port"]["te"][:, j, i], arr["ref"]["te"][:, j, i]
            both = np.concatenate([te_p, te_r])
            mid = 0.5 * (both.min() + both.max())
            for name, p_hit, r_hit in (
                    ("no_census", arr["port"]["npcen"][:, j, i] == 0,
                     arr["ref"]["npcen"][:, j, i] == 0),
                    ("upper_te", te_p > mid, te_r > mid)):
                sp, sr = int(p_hit.sum()), int(r_hit.sum())
                row[name] = {"port": [sp, len(p_hit)], "ref": [sr, len(r_hit)],
                             "fisher_p": fisher_two_sided(sp, len(p_hit), sr,
                                                          len(r_hit))}
            out.append(row)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--side", choices=("jax", "port"))
    ap.add_argument("--cell", choices=sorted(e2e_gate.CELLS),
                    default="grid_40x30")
    ap.add_argument("--seeds", type=int, default=48)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2, metavar=("REF", "PORT"))
    ap.add_argument("--rows", type=int, default=2)
    args = ap.parse_args()
    if args.compare:
        with open(args.compare[0]) as f:
            ref = json.load(f)
        with open(args.compare[1]) as f:
            port = json.load(f)
        for row in compare(ref, port, args.rows):
            print(json.dumps(row))
        return
    rc = e2e_gate.load_reference()[args.cell]
    base = e2e_gate.REF_SEED if args.side == "jax" else e2e_gate.PORT_SEED
    seeds = [base + 13 * i for i in range(args.seeds)]
    t0 = time.perf_counter()
    if args.side == "jax":
        reps = run_jax(args.cell, rc, seeds)
    else:
        reps = run_port(args.cell, rc, seeds, args.device)
    data = {"side": args.side, "cell": args.cell,
            "statistic": rc["statistic"], "steps": rc["steps"],
            "seeds": seeds, "seconds": time.perf_counter() - t0,
            "replicates": reps}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(data, f)
    print(f"{args.side} {args.cell}: {len(seeds)} seeds in "
          f"{data['seconds']:.1f} s -> {args.out}")


if __name__ == "__main__":
    main()
