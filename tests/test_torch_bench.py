"""The port's benchmark (``compton2d_tpu_torch.bench``) against the
repository's ``bench.py``: the same environment settings and sizes, a
record with its keys (less ``vs_baseline``), and the HBM share computed
from the port's own byte model, on the CPU at the small size."""
import ast
import json
import os
import re

import pytest
import torch

from compton2d_tpu_torch import bench, roofline

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETTINGS = ("BENCH_SIZE", "BENCH_STEPS", "BENCH_TCONST", "BENCH_MAX_ITERS",
            "BENCH_MRK421", "BENCH_PALLAS_E2E")


def _reference_bench():
    """bench.py's syntax tree (read, not imported: it imports jax)."""
    with open(os.path.join(REPO, "bench.py")) as f:
        return ast.parse(f.read())


def _record_keys(tree) -> set:
    """The keys of bench.py's record: its dict literal and the keys it
    sets after."""
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "rec"
                for t in node.targets):
            keys |= {k.value for k in node.value.keys}
        if (isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store)
                and isinstance(node.value, ast.Name)
                and node.value.id == "rec"):
            keys.add(node.slice.value)
    return keys


def _constant_kwargs(call) -> dict:
    out = {}
    for kw in call.keywords:
        try:
            out[kw.arg] = eval(compile(ast.Expression(kw.value), "bench",
                                       "eval"), {"__builtins__": {}})
        except NameError:
            pass   # read from the environment
    return out


def test_sizes_and_settings_are_bench_pys():
    """The three sizes are bench.py's small_corona arguments (its constant
    ones; t_const and the flight budget come from the environment), and
    the environment's defaults are bench.py's."""
    tree = _reference_bench()
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "small_corona"]
    calls.sort(key=lambda n: n.lineno)
    assert len(calls) == 3
    for size, call in zip(("small", "large", "full"), calls):
        want = _constant_kwargs(call)
        t_const = want.pop("t_const", None)
        assert bench.SIZES[size] == want, size
        if t_const is not None:
            assert bench.settings({"BENCH_SIZE": size})["t_const"] is t_const
    names = {n.args[0].value for n in ast.walk(tree)
             if isinstance(n, ast.Call) and getattr(n.func, "attr", "") == "get"
             and n.args and isinstance(n.args[0], ast.Constant)}
    assert names == set(SETTINGS)
    full = bench.settings({})
    assert full == dict(size="full", steps=16, t_const=False, max_iters=256,
                        mrk421=True, pallas_e2e=True)
    small = bench.settings({"BENCH_SIZE": "small"})
    assert small == dict(size="small", steps=3, t_const=True, max_iters=256,
                         mrk421=False, pallas_e2e=False)
    assert bench.settings({"BENCH_SIZE": "large", "BENCH_STEPS": "5",
                           "BENCH_TCONST": "1", "BENCH_MRK421": "0",
                           "BENCH_PALLAS_E2E": "0"}) == dict(
        size="large", steps=5, t_const=True, max_iters=256, mrk421=False,
        pallas_e2e=False)
    with pytest.raises(ValueError):
        bench.settings({"BENCH_SIZE": "huge"})


def test_small_record_on_cpu(monkeypatch, capsys):
    """BENCH_SIZE=small with --device cpu, one timed step: the last line
    is one record with bench.py's keys less vs_baseline, a positive rate,
    and the HBM share of roofline.round_bytes times the rounds over the
    timed seconds at PEAK_BYTES_S; the summary goes to stderr."""
    for name in SETTINGS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("BENCH_SIZE", "small")
    monkeypatch.setenv("BENCH_STEPS", "1")
    assert bench.main(["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    rec = json.loads(out.strip().splitlines()[-1])
    keys = _record_keys(_reference_bench())
    # the record's keys at the small size: bench.py's unconditional ones
    base = {"metric", "value", "unit", "vs_baseline",
            "step_hbm_model_pct_of_peak", "tracking_rounds_per_step"}
    assert base <= keys
    assert (base - {"vs_baseline"}) | {"device"} <= set(rec)
    assert not ({"vs_baseline", "mrk421_histories_per_s", "pallas_e2e",
                 "pallas_e2e_strat"} & set(rec))
    assert rec["metric"] == "photon_histories_per_sec_per_chip"
    assert rec["unit"] == "histories/s" and rec["device"] == "cpu"
    assert rec["value"] > 0 and rec["steps"] == 1 and rec["rounds"] >= 1
    assert rec["value"] == pytest.approx(rec["histories"] / rec["measure_s"],
                                         rel=1e-12)
    assert rec["tracking_rounds_per_step"] == rec["rounds"]
    sim = bench.build(bench.settings(), "cpu")
    assert rec["round_bytes"] == roofline.round_bytes(sim)
    want = (100.0 * rec["rounds"] * roofline.round_bytes(sim)
            / roofline.PEAK_BYTES_S / rec["measure_s"])
    assert rec["step_hbm_model_pct_of_peak"] == pytest.approx(want, rel=1e-12)
    # the plain flight version on the CPU counts no launch
    assert set(rec["flight_launches"].values()) == {0}
    assert rec["tracker"] == "kernel"
    assert err.strip().splitlines()[-1].startswith("# first step=")


def test_no_reference_device_constants():
    """None of bench.py's figures for its own chip (the HBM peak, the
    self-baseline) is in the port's module; every record key bench.py
    sets, less vs_baseline, is one the port's full-size run sets."""
    path = bench.__file__
    with open(path) as f:
        src = f.read()
    for figure in ("819", "1.0e5", "1e5", "100000"):
        assert figure not in src, figure
    for name in ("PEAK_HBM_GBS", "BASELINE_VALUE"):
        assert not hasattr(bench, name)
    assert not re.search(r"\btpu\b|\bv5e\b", src, re.IGNORECASE)
    keys = _record_keys(_reference_bench()) - {"vs_baseline"}
    assert keys == {"metric", "value", "unit", "step_hbm_model_pct_of_peak",
                    "tracking_rounds_per_step", "mrk421_histories_per_s",
                    "pallas_e2e", "pallas_e2e_strat"}
    assert set(bench.GATES) == {"pallas_e2e", "pallas_e2e_strat"}
    assert bench.GATE_KEYS == ("passed", "rel_dev", "noise_floor",
                               "n_stiff_zones")


def test_gate_record_that_cannot_run():
    """A gate that cannot run is recorded as failed, with its error."""
    rec = bench.gate_record("no_such_cell", "cpu")
    assert rec["passed"] is False and "KeyError" in rec["error"]
