"""The benchmark's files: every configuration and cell loads and builds,
an unknown or missing key is refused, and the frozen reference imports
nothing of the port, of JAX or of the JAX package."""
import json
import subprocess
import sys

import pytest

from conftest import BENCH
from harness import guard, specs


def test_every_cell_and_config_loads_and_builds():
    bench = specs.load_benchmark()
    names = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        wl = specs.load_workload(w["name"])
        assert wl["config"] == w["config"] in names
        assert wl["ranks"] == w["chips"] and wl["why"] == w["why"]
        cfg, zi = specs.sim_config(specs.load_config(w["config"]), wl,
                                   2 ** 31 + 5)
        assert cfg.run.n_slots == wl["slots"]
        assert cfg.source.nst == wl["nst"]
        assert cfg.run.seed == 2 ** 31 + 5
        assert zi.tea.shape == (cfg.grid.nz, cfg.grid.nr)
    for c in bench["configs"]:
        assert c["reduced"] == specs.load_config(c["name"])["reduced"]
    for spec in bench["end_to_end"] + bench["per_layer"]:
        specs.load_metric(spec["name"])


@pytest.mark.parametrize("kind, drop", [
    ("config", False), ("config", True), ("workload", False),
    ("workload", True), ("grid", False), ("grid", True)])
def test_unknown_or_missing_key_is_refused(tmp_path, kind, drop):
    root = tmp_path / "benchmark"
    for sub in ("configs", "workloads"):
        (root / sub).mkdir(parents=True)
    c = json.loads((BENCH / "configs" / "corona99.json").read_text())
    w = json.loads((BENCH / "workloads" / "corona99.evolve.json").read_text())
    target = {"config": c, "workload": w, "grid": c["grid"]}[kind]
    if drop:
        target.pop(sorted(target)[0])
    else:
        target["surplus"] = 1
    (root / "configs" / "corona99.json").write_text(json.dumps(c))
    (root / "workloads" / "corona99.evolve.json").write_text(json.dumps(w))
    with pytest.raises(specs.SpecError):
        wl = specs.load_workload("corona99.evolve", root)
        specs.sim_config(specs.load_config("corona99", root), wl, 1)


@pytest.mark.parametrize("name, bad", [
    ("compton2d_tpu_torch", False), ("compton2d_tpu_torch.driver", False),
    ("compton2d_tpu", True), ("compton2d_tpu.driver", True),
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax", True), ("jaxtyping", False), ("c2dref.step", False)])
def test_import_check_compares_whole_top_level_names(name, bad):
    assert guard.forbidden_modules({name: None}) == ([name] if bad else [])
    if bad:
        with pytest.raises(SystemExit):
            guard.check("test", {name: None})
    else:
        guard.check("test", {name: None})


def test_reference_imports_nothing_of_the_port_or_jax():
    code = (
        "import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "import c2dref.step, postprocess\n"
        "from harness import guard\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "guard.FORBIDDEN | {'compton2d_tpu_torch'}]\n"
        "print(bad); assert not bad\n"
    ) % (str(BENCH / "reference"), str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _cells(bench):
    return {w["name"]: specs.load_workload(w["name"])
            for w in bench["workloads"]}


@pytest.mark.parametrize("metric", ["ranks_step_ms", "exchange_ms"])
def test_ranks_metrics_list_only_cells_on_several_ranks(metric):
    bench = specs.load_benchmark()
    cells = _cells(bench)
    spec = next(s for s in bench["end_to_end"] + bench["per_layer"]
                if s["name"] == metric)
    assert spec["workloads"]
    assert all(cells[n]["ranks"] > 1 for n in spec["workloads"])


def test_at_most_one_cell_asks_for_four_chips():
    bench = specs.load_benchmark()
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= 1
