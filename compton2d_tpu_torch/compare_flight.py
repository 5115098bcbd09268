"""Earlier versions of the flight kernel against the package's, on a card.

Each version is a copy of this package's ``transport/flight.py`` and
``csrc/flight.cu`` from another commit, run through its own wrapper, so
its C interface does not matter. Unpack each into a git-ignored directory
and run from the repository root::

    git archive <commit> compton2d_tpu_torch/transport/flight.py \\
        compton2d_tpu_torch/csrc/flight.cu \\
        | tar -x -C compton2d_tpu_torch/_build/old
    python3 -m compton2d_tpu_torch.compare_flight \\
        compton2d_tpu_torch/_build/old/compton2d_tpu_torch

At every kernel mode's path shapes (:func:`modes`, inputs from
``chip_smoke.path_inputs``, each version's tables built by its own
``build_flight_tables`` from the same arrays) it checks that each earlier
version's per-lane outputs and ``it_used`` are bitwise equal to the
package's, with the tallies and energy sums within 1e-5 of their scale,
and times every version on the device alone, in turns (each version in
order, then in reverse): REPS wrapper calls a turn, each kernel launch
bracketed by CUDA events behind a spin kernel that keeps the stream busy,
so that no host time falls between the events; the median launch of each
turn. It prints one JSON line per mode, with each version's SIMT
efficiency where its result carries counters whose first four columns
are lane-iterations and the warp passes through FLY, SCT_A and SCT_B,
and, last, the card's line.
"""
from __future__ import annotations

import importlib.util
import inspect
import json
import statistics
import sys
from pathlib import Path

import torch

from compton2d_tpu_torch import kernel_build
from compton2d_tpu_torch.bench import card_line
from compton2d_tpu_torch.transport import flight

REPS = 20
SPIN_CYCLES = 200000   # about 0.1 ms of the card's clock before each launch
LANE_OUTPUTS = ("e", "w", "r", "z", "mu", "cphi", "sphi", "dcen", "jz", "kr",
                "alive", "mode", "flag", "jn", "kn", "sct_cnt", "iglog",
                "delog")


def modes(cs):
    """Every kernel mode at its path's shapes, from chip_smoke's
    constants: (label, nz, nr, inline_scatter, pair_switch, max_iters,
    kernel_inputs shapes)."""
    pair = dict(n=cs.PAIR_SLOTS, n_vol=cs.PAIR_VOL, num_nt=cs.PAIR_NT,
                n_gg=cs.PAIR_GG)
    return (
        ("B1", cs.NZ, cs.NR, True, False, 256, {}),
        ("B3", cs.MRK_NZ, cs.MRK_NR, False, False, 512, {}),
        ("B2", cs.PAIR_NZ, cs.PAIR_NR, True, True, 256, pair),
        ("B2 with B3", cs.PAIR_NZ, cs.PAIR_NR, False, True, 256, pair),
        ("B4", cs.LARGE_NZ, cs.LARGE_NR, True, False, 256,
         dict(n=cs.LARGE_SLOTS)),
        ("B1 at 32x32", cs.RESIDENT_NZ, cs.RESIDENT_NR, True, False, 256, {}),
    )


def lanes_equal(a, b, label: str) -> None:
    """Per-lane outputs and it_used of two results bitwise equal."""
    for f in LANE_OUTPUTS:
        if not torch.equal(getattr(a, f), getattr(b, f)):
            bad = int((getattr(a, f) != getattr(b, f)).sum())
            raise AssertionError(f"{label} {f}: {bad} lanes differ")
    if a.it_used != b.it_used:
        raise AssertionError(f"{label} it_used {a.it_used} != {b.it_used}")


class _TimedLib:
    """A loaded kernel library whose ``flight_launch`` records CUDA events
    around each launch."""

    def __init__(self, lib):
        self._lib = lib
        self.events = []

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def flight_launch(self, *args):
        torch.cuda._sleep(SPIN_CYCLES)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        rc = self._lib.flight_launch(*args)
        t1.record()
        self.events.append((t0, t1))
        return rc


def load_version(root: Path, tag: str):
    """The wrapper module of the version under ``root`` (a copy of the
    package directory), built from its own source, its library timed."""
    name = f"compton2d_tpu_torch.transport._flight_{tag}"
    spec = importlib.util.spec_from_file_location(
        name, root / "transport" / "flight.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    mod.build()
    mod._lib = _TimedLib(mod._lib)
    return mod


def main(argv=None) -> int:
    import chip_smoke as cs   # run from the repository root

    roots = [Path(a) for a in (argv if argv is not None else sys.argv[1:])]
    if not torch.cuda.is_available():
        print("compare_flight: no CUDA device", file=sys.stderr)
        return 1
    card = card_line("cuda")
    flight.build()
    flight._lib = _TimedLib(flight._lib)
    versions = [("package", flight)] + [
        (str(r), load_version(r, f"v{i}")) for i, r in enumerate(roots)]
    for label, mod in versions:
        src = Path(mod._SOURCE)
        kernel_build.compile_source(src)
        print(f"{label}: {src}\n{flight.ptxas_report(src)}", flush=True)
    device = torch.device("cuda", 0)
    captured = {}
    build_tables = flight.build_flight_tables

    def capture(*a, **k):
        captured.update(args=a, kwargs=k)
        return build_tables(*a, **k)

    for label, nz, nr, inline, pairs, iters, shapes in modes(cs):
        flight.build_flight_tables = capture
        try:
            photons, _, seeds = cs.path_inputs(device, nz, nr, **shapes)
        finally:
            flight.build_flight_tables = build_tables
        kw = dict(nz=nz, nr=nr, inline=inline, pairs=pairs)
        # a version that makes its guide edges itself takes no u_edges
        tables = [mod.build_flight_tables(*captured["args"], **{
            k: v for k, v in captured["kwargs"].items()
            if k in inspect.signature(mod.build_flight_tables).parameters})
            for _, mod in versions]
        results = [cs.run_flight(mod.flight_step, photons, tab, seeds, iters,
                                 **kw)
                   for (_, mod), tab in zip(versions, tables)]
        e_scale = float(torch.sum(photons["w"]))
        for (v, _), res in zip(versions[1:], results[1:]):
            lanes_equal(results[0], res, f"{label} {v}")
            cs.assert_sums_close(res, results[0], 1e-5, e_scale,
                                 f"{label} {v}")
        times = {v: [] for v, _ in versions}
        order = list(zip(versions, tables))
        for (v, mod), tab in order + order[::-1]:
            mod._lib.events.clear()
            for _ in range(REPS):
                cs.run_flight(mod.flight_step, photons, tab, seeds, iters,
                              **kw)
            torch.cuda.synchronize()
            times[v].append(statistics.median(
                t0.elapsed_time(t1) for t0, t1 in mod._lib.events))
        simt = {}
        for (v, _), res in zip(versions, results):
            counters = getattr(res, "counters", None)
            c = ([0] * 4 if counters is None
                 else counters.sum(dim=0, dtype=torch.int64).tolist())
            if c[1] + c[2] + c[3] > 0:
                simt[v] = c[0] / (32.0 * (c[1] + c[2] + c[3]))
        print(json.dumps({"mode": label, "device_ms": times,
                          "simt_efficiency": simt,
                          "it_used": results[0].it_used}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
