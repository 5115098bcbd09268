"""One run of one cell: set-up, the measured window, the traced stretch
and the readings the check compares.

Two kinds of window, chosen by the workload's ``kind``:

- ``to_tstop``: each repetition is a whole run from the state set-up
  took at t = 0 to ``t_stop``, with the outputs attached
  (``Simulation.run_to_stop``, which finalizes them), then the event file
  read back and post-processed (``run_mrk421.postprocess``).
- ``segment``: set-up steps the cell ``setup_steps`` times from t = 0 and
  takes that state; each repetition restores it (a device copy) and
  steps ``segment_steps`` times. On several ranks all stop at the same
  cycle's end, on the largest of their flags.

Each repetition runs one of the workload's fixed random ``streams`` (a
stream's seed, on a rank the program's ``rank_seed`` of it), and the
window cycles through all of them in an order drawn from ``--seed``,
ending at the end of the cycle in progress: every seed gives the same set
of runs, in another order, so the window's work does not depend on the
seed (the stream moves the FP solve's substeps by some 15% a run). The
set-up steps of a segment cell run the first stream. The pre-step states
of the last repetition, its random stream and its outputs are kept by
reference (the step builds new tensors) for the check after the window.
"""
from __future__ import annotations

import os
import resource
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from harness import guard, specs


def clone(x):
    """A copy of a state tree: tensors cloned, a generator kept."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[clone(v) for v in x])
    return x


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Capture:
    """The steps of one repetition: (pre-step state, its random stream's
    state, the step's outputs) each, and the state after the last."""

    def __init__(self):
        self.steps = []
        self.final = None


class CellRun:
    """Set-up, window and readings of workload ``name`` on ``device``
    (this rank of ``mesh`` when the cell runs on several ranks)."""

    def __init__(self, name: str, seed: int, seconds: float, device,
                 mesh=None, root: Path = specs.ROOT,
                 t_start: Optional[float] = None):
        self.t_start = time.time() if t_start is None else t_start
        self.seed, self.seconds = int(seed), float(seconds)
        self.device = torch.device(device)
        self.mesh = mesh
        self.w = specs.load_workload(name, root)
        self.c = specs.load_config(self.w["config"], root)
        self.cfg, self.zone_init = specs.sim_config(self.c, self.w,
                                                    self.w["streams"][0])
        self.order = [int(k) for k in np.random.default_rng(
            self.seed).permutation(len(self.w["streams"]))]
        self.tmp = tempfile.TemporaryDirectory(prefix="c2d_bench_")
        self.out_dir = os.path.join(self.tmp.name, "run")
        self.outputs = []          # each step's 0-d counts
        self.event_bytes = 0

    # ---------------------------------------------------------------- set-up
    def setup(self) -> None:
        from compton2d_tpu_torch.driver import Simulation
        from compton2d_tpu_torch.parallel.mesh import rank_seed

        self.sim = Simulation(self.cfg, self.zone_init, device=self.device,
                              mesh=self.mesh)
        self.gen = self.sim.state.key
        self.initial = clone(self.sim.state)
        if self.w["kind"] == "segment":
            for _ in range(self.w["setup_steps"]):
                self.sim.step()
        self.snapshot = clone(self.sim.state)
        rank = 0 if self.mesh is None else self.mesh.rank
        self.gen_states = []
        for s in self.w["streams"]:
            self.gen.manual_seed(rank_seed(int(s), rank))
            self.gen_states.append(self.gen.get_state())
        self.unit(self.order[0], n_steps=self.w["warm_steps"],
                  out_dir=self._other())
        _sync(self.device)

    def _other(self) -> str:
        return os.path.join(self.tmp.name, "other")

    # ------------------------------------------------------------ the work
    def unit(self, stream: int = 0, capture: Optional[Capture] = None,
             start=None, n_steps: Optional[int] = None,
             out_dir: Optional[str] = None) -> int:
        """One repetition of stream number ``stream`` from set-up's state,
        or from ``start`` (a state and its random stream's state): a whole
        run to t_stop with its outputs, or a segment; with ``n_steps``,
        that many steps of it (and a run's outputs of those steps).
        Returns its steps."""
        state, g = start or (self.snapshot, self.gen_states[stream])
        self.sim.state = clone(state)
        self.gen.set_state(g)
        cap = capture if capture is not None else Capture()
        sim = self.sim
        step = sim.step

        def recorded():
            pre, g = sim.state, self.gen.get_state()
            out = step()
            cap.steps.append((pre, g, out))
            t = out.tallies    # the 0-d counts alone, not the tallies
            self.outputs.append((out.n_tracked, out.fp_substeps,
                                 t.trk_rounds, t.n_window, t.n_straggler))
            return out

        if self.w["kind"] == "to_tstop":
            from compton2d_tpu_torch import run_mrk421
            from compton2d_tpu_torch.io import events

            out_dir = out_dir or self.out_dir
            sim.attach_outputs(out_dir, event_file="evb.dat")
            if n_steps:
                for _ in range(n_steps):
                    recorded()
                sim.finalize_outputs()
            else:
                sim.step = recorded
                try:
                    sim.run_to_stop()
                finally:
                    del sim.step
            path = os.path.join(out_dir, "evb.dat")
            self.event_bytes = os.path.getsize(path)
            ev = events.read_event_file(path)
            run_mrk421.postprocess(ev, self.cfg.grid.r_max, out_dir)
        else:
            for _ in range(n_steps or self.w["segment_steps"]):
                recorded()
        cap.final = sim.state
        return len(cap.steps)

    def _stop_together(self, stop: bool) -> bool:
        if self.mesh is None:
            return stop
        import torch.distributed as dist

        flag = torch.tensor([int(stop)], dtype=torch.int32,
                            device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def window(self) -> dict:
        """The measured window; returns its counts and times."""
        self.outputs.clear()
        comm0 = self.mesh.comm_s if self.mesh is not None else 0.0
        self.setup_s = time.time() - self.t_start
        guard.check("end of set-up")
        _sync(self.device)
        ru0 = resource.getrusage(resource.RUSAGE_SELF)
        t0 = time.perf_counter()
        units = steps = 0
        unit_s = []
        while True:
            for k in self.order:
                self.last = Capture()
                steps += self.unit(k, capture=self.last)
                units += 1
                unit_s.append(time.perf_counter() - t0)
            if self._stop_together(time.perf_counter() - t0
                                   >= self.seconds):
                break
        _sync(self.device)
        window_s = time.perf_counter() - t0
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
        guard.check("end of the window")
        sums = torch.stack([torch.stack([x.to(torch.int64) for x in o])
                            for o in self.outputs]).sum(0).tolist()
        rec = {
            "window_s": window_s, "units": units, "steps": steps,
            "unit_ends_s": unit_s,
            "setup_s": self.setup_s,
            **dict(zip(("histories", "fp_substeps", "rounds", "n_window",
                        "n_straggler"), sums)),
            "comm_s": (self.mesh.comm_s - comm0) if self.mesh else 0.0,
            "event_bytes": self.event_bytes,
            # the host thread's CPU seconds and context switches in the
            # window: whether it waited for its core or for the card
            "host": {"cpu_s": (ru1.ru_utime + ru1.ru_stime)
                     - (ru0.ru_utime + ru0.ru_stime),
                     "nvcsw": ru1.ru_nvcsw - ru0.ru_nvcsw,
                     "nivcsw": ru1.ru_nivcsw - ru0.ru_nivcsw},
        }
        self.outputs.clear()
        return rec

    def _align(self) -> None:
        """Wait for every rank: an all_reduce of one element on the card,
        then the card synchronised."""
        import torch.distributed as dist

        dist.all_reduce(torch.zeros(1, device=self.device))
        _sync(self.device)

    def traced(self, spans) -> dict:
        """The last ``trace_steps`` steps of the window's last repetition
        (with a run's outputs of those steps), run again after the window
        from their pre-step state, timed as the window runs them and then
        under the profiler; on several ranks each run starts with the
        ranks lined up."""
        from harness import trace

        k = min(self.w["trace_steps"], len(self.last.steps))
        pre, g, _ = self.last.steps[-k]
        _, tr = trace.profile(lambda: self.unit(
            start=(pre, g), n_steps=k, out_dir=self._other()), spans,
            align=None if self.mesh is None else self._align)
        self.outputs.clear()
        return tr

    def close(self) -> None:
        self.tmp.cleanup()
