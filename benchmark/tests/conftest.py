"""Fixtures of the benchmark's own tests: a copy of the benchmark folder
with tiny cells beside the real ones, run on the CPU."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
for p in (BENCH.parent, BENCH):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

TINY_LIMITS = {"step_rel": 1e-6, "free_rel": 1e-6}


def tiny_files(root: Path) -> None:
    """Tiny configurations and cells of both kinds, as new files."""
    c = json.loads((root / "configs" / "mrk421_dense.json").read_text())
    c["grid"].update(nz=4, nr=2, num_nt=160, n_vol=64, nphfield=64)
    c["run"]["event_capacity"] = 8192
    c["sourcing"]["strat_copies"] = 4
    (root / "configs" / "tiny_blob.json").write_text(json.dumps(c))
    c = json.loads((root / "configs" / "corona99.json").read_text())
    c["grid"].update(nz=3, nr=2, num_nt=50, n_vol=64, nphfield=64)
    c["run"]["event_capacity"] = 4096
    (root / "configs" / "tiny_corona.json").write_text(json.dumps(c))
    common = {"ranks": 1, "backend": "none", "warm_steps": 1,
              "streams": [11, 12],
              "check_steps": 3, "trace_steps": 2, "why": "a test"}
    cells = {
        "tiny_blob.run": dict(common, config="tiny_blob", kind="to_tstop",
                              nst=1500, slots=8192, free_steps=2,
                              limits=dict(
                                  TINY_LIMITS, outputs_rel=1e-5)),
        "tiny_corona.evolve": dict(common, config="tiny_corona",
                                   kind="segment", nst=3000, slots=4096,
                                   setup_steps=2, segment_steps=3,
                                   limits=TINY_LIMITS),
        "tiny_corona.ranks2": dict(common, config="tiny_corona",
                                   kind="segment", nst=3000, slots=4096,
                                   setup_steps=2, segment_steps=2,
                                   ranks=2, backend="gloo", check_steps=2,
                                   limits=dict(TINY_LIMITS, ranks_diff=0.0)),
    }
    for name, w in cells.items():
        (root / "workloads" / f"{name}.json").write_text(json.dumps(w))
    bench = json.loads((root.parent / "BENCHMARK.json").read_text())
    names = list(cells)
    bench["workloads"] = [
        {"name": n, "config": w["config"], "traffic": n.split(".", 1)[1],
         "chips": w["ranks"], "why": w["why"]} for n, w in cells.items()]
    for spec in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in spec:
            kinds = {"run_s": "to_tstop", "outputs_ms": "to_tstop",
                     "step_ms": "segment"}
            spec["workloads"] = (
                ["tiny_corona.ranks2"] if spec["name"] in (
                    "exchange_ms", "ranks_step_ms")
                else [n for n in names
                      if kinds.get(spec["name"]) in (None,
                                                     cells[n]["kind"])
                      and not (spec["name"] == "step_ms"
                               and cells[n]["ranks"] > 1)])
    (root.parent / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    """A copy of the benchmark folder and BENCHMARK.json with the tiny
    cells added."""
    root = tmp_path / "benchmark"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    tiny_files(root)
    return root


def run_cell(root: Path, cell: str, trace: int = 0, seed: int = 2 ** 31 + 7,
             seconds: float = 0.0, before=None):
    """One run of ``cell`` on the CPU, the chip check skipped: the last
    line's object."""
    import run as entry

    args = entry.parser().parse_args([
        "--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
        "--trace", str(trace)])
    rec = entry.collect(args, "cpu", root, before)
    res, _, _ = entry.result(args, rec, root)
    return res
