"""Loading a cell's files and building the deployment they describe.

Every file is refused on an unknown or missing key. The configuration
file writes out every field of the program's ``SimConfig`` and
``ZoneInit`` itself, so no default of the program's examples can change a
deployment; the traffic keys (photons a step, slots, seed) come from the
workload and the command line.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Tuple

ROOT = Path(__file__).resolve().parent.parent      # the benchmark folder

WORKLOAD_KEYS = {
    "config", "kind", "nst", "slots", "ranks", "backend", "setup_steps",
    "segment_steps", "warm_steps", "check_steps", "trace_steps", "limits",
    "streams", "free_steps", "why",
}
KINDS = ("to_tstop", "segment")
CONFIG_KEYS = {"source", "assumed", "reduced", "precision", "grid",
               "physics", "sourcing", "run", "windows", "zones",
               "postprocess"}
# set by the workload and the command line, never by the configuration
TRAFFIC = {"sourcing": ("nst",), "run": ("n_slots", "seed")}
LAYER_KEYS = {"layer", "spans"}
LIMIT_NAMES = ("step_rel", "free_rel", "outputs_rel", "ranks_diff")


class SpecError(ValueError):
    """A cell's file is malformed."""


def _load_json(path: Path) -> dict:
    if not path.is_file():
        raise SpecError(f"{path}: no such file")
    with open(path) as fh:
        return json.load(fh)


def _keys(d: dict, allowed: set, what: str, required=None) -> None:
    extra = set(d) - allowed
    if extra:
        raise SpecError(f"{what}: unknown keys {sorted(extra)}")
    missing = set(allowed if required is None else required) - set(d)
    if missing:
        raise SpecError(f"{what}: missing keys {sorted(missing)}")


def load_workload(name: str, root: Path = ROOT) -> dict:
    w = _load_json(root / "workloads" / f"{name}.json")
    _keys(w, WORKLOAD_KEYS, f"workload {name}",
          required=WORKLOAD_KEYS - {"segment_steps", "setup_steps",
                                    "free_steps"})
    if w["kind"] not in KINDS:
        raise SpecError(f"workload {name}: kind {w['kind']!r} not in {KINDS}")
    if w["kind"] == "segment" and not {"segment_steps",
                                       "setup_steps"} <= set(w):
        raise SpecError(f"workload {name}: a segment window needs "
                        "segment_steps and setup_steps")
    if w["kind"] == "to_tstop" and "free_steps" not in w:
        raise SpecError(f"workload {name}: a to_tstop window needs "
                        "free_steps")
    bad = set(w["limits"]) - set(LIMIT_NAMES)
    if bad:
        raise SpecError(f"workload {name}: unknown limits {sorted(bad)}")
    if w["ranks"] > 1 and w["backend"] not in ("nccl", "gloo"):
        raise SpecError(f"workload {name}: {w['ranks']} ranks need the "
                        "nccl or gloo backend")
    return w


def load_config(name: str, root: Path = ROOT) -> dict:
    c = _load_json(root / "configs" / f"{name}.json")
    _keys(c, CONFIG_KEYS, f"config {name}", required=CONFIG_KEYS - {
        "postprocess"})
    return c


def load_layers(root: Path = ROOT) -> Dict[str, List[Tuple[str, str]]]:
    """Every layer file: its name (the file's stem) -> its spans, each a
    (module, attribute) pair; an attribute may name a class's method as
    ``Class.method``."""
    out = {}
    for p in sorted((root / "layers").glob("*.json")):
        d = _load_json(p)
        _keys(d, LAYER_KEYS, f"layer {p.stem}")
        out[p.stem] = [(m, a) for m, a in d["spans"]]
    return out


def load_metric(name: str, root: Path = ROOT) -> ModuleType:
    """The reader module of per-layer metric ``name``: it defines
    ``read(m)``, which returns the metric's value or None."""
    path = root / "metrics" / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"metric {name}: no reader {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not callable(getattr(mod, "read", None)):
        raise SpecError(f"metric {name}: {path} defines no read(m)")
    return mod


def load_benchmark(root: Path = ROOT) -> dict:
    """The repository's BENCHMARK.json beside the benchmark folder."""
    return _load_json(root.parent / "BENCHMARK.json")


def _build(cls, d: dict, what: str, skip=(), nested=None):
    """``cls(**d)`` with every field of the dataclass given, less
    ``skip``; ``nested`` maps a field to the builder of its value."""
    names = {f.name for f in dataclasses.fields(cls)} - set(skip)
    _keys(d, names, what)
    kw = {}
    for k, v in d.items():
        if nested and k in nested:
            v = nested[k](v)
        elif isinstance(v, list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        kw[k] = v
    return kw


def sim_config(c: dict, w: dict, seed: int):
    """The program's ``SimConfig`` and ``ZoneInit`` of configuration ``c``
    under workload ``w`` and ``seed``."""
    from compton2d_tpu_torch import config as pc

    g = pc.GridConfig(**_build(pc.GridConfig, c["grid"], "grid"))
    ph = c["physics"]
    phys = pc.PhysicsConfig(**_build(pc.PhysicsConfig, ph, "physics", nested={
        "flare": lambda d: pc.FlareConfig(**_build(pc.FlareConfig, d,
                                                   "physics.flare")),
        "injection": lambda d: pc.InjectionConfig(**_build(
            pc.InjectionConfig, d, "physics.injection")),
    }))
    src = pc.SourceConfig(nst=int(w["nst"]), **_build(
        pc.SourceConfig, c["sourcing"], "sourcing", skip=TRAFFIC["sourcing"],
        nested={"external": lambda d: pc.ExternalRadiationConfig(**_build(
            pc.ExternalRadiationConfig, d, "sourcing.external"))}))
    run = pc.RunConfig(n_slots=int(w["slots"]), seed=int(seed), **_build(
        pc.RunConfig, c["run"], "run", skip=TRAFFIC["run"]))

    def ring(v, n):
        return tuple(float(x) for x in v) if isinstance(v, list) \
            else (float(v),) * n

    wins = []
    for i, wd in enumerate(c["windows"]):
        _keys(wd, {f.name for f in dataclasses.fields(pc.TimeWindow)},
              f"windows[{i}]")
        wins.append(pc.TimeWindow(
            t0=float(wd["t0"]), t1=float(wd["t1"]),
            tbb_upper=ring(wd["tbb_upper"], g.nr),
            tbb_lower=ring(wd["tbb_lower"], g.nr),
            tbb_inner=ring(wd["tbb_inner"], g.nz),
            tbb_outer=ring(wd["tbb_outer"], g.nz),
            upper_spectra=tuple(wd["upper_spectra"]),
            lower_spectra=tuple(wd["lower_spectra"])))
    cfg = pc.SimConfig(grid=g, physics=phys, source=src, run=run,
                       windows=tuple(wins))
    z = c["zones"]
    _keys(z, {f.name for f in dataclasses.fields(pc.ZoneInit)}, "zones")
    zi = pc.ZoneInit.uniform(g, **z)
    return cfg, zi
