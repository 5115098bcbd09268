"""The benchmark of compton2d_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--control 1]

Reads ``BENCHMARK.json`` and the cell's files under ``benchmark/``, runs
the cell on the CUDA cards (one process a rank), and prints one JSON
object as the last line of its standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer metrics), ``device`` and, traced,
``breakdown``; the numbers compared for ``correct`` come last in it
(``checks``) and as the last lines of standard error. ``--control 1``
prints the control's readings (the reference with TF32 on in the
program's place) beside the program's. Exits non-zero without a result
when there is no CUDA card, too few of them, or a module of JAX or of
the JAX package is loaded.
"""
from __future__ import annotations

import time

T_WALL = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
for p in (HERE.parent, HERE):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402

from harness import guard, specs  # noqa: E402


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap


def card_index(device) -> int:
    """The card's index among the host's cards: its entry of
    ``CUDA_VISIBLE_DEVICES`` when that names cards by number, else its
    index in this process."""
    index = torch.device(device).index or 0
    visible = [v.strip() for v in
               os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")
               if v.strip()]
    if index < len(visible) and visible[index].isdigit():
        return int(visible[index])
    return index


def pin(device) -> int:
    """Keep this rank's process, with one CPU thread for PyTorch, on one
    core of those the launcher lets it use, chosen by the card it drives
    (the cores 2, 6, 10, ... of that set for the cards 0, 1, 2, ...), as
    an MPI launcher binds one rank to a core: the step is bound by the
    host's launches, and a process that moves between cores runs them
    less steadily. Processes on different cards never share a core.
    Returns the core."""
    cores = sorted(os.sched_getaffinity(0))
    core = cores[(2 + 4 * card_index(device)) % len(cores)]
    os.sched_setaffinity(0, {core})
    torch.set_num_threads(1)
    return core


def run_rank(args, device, mesh=None, t_wall: float = T_WALL,
             root: Path = specs.ROOT) -> dict:
    """Set-up, window, traced stretch and check of this rank; returns its
    record (plain numbers, on the host)."""
    from harness.cell import CellRun
    from harness import check
    from harness.spans import Spans

    core = pin(device) if torch.device(device).type == "cuda" else None
    cell = CellRun(args.workload, args.seed, args.seconds, device, mesh,
                   root, t_start=t_wall)
    spans = Spans(specs.load_layers(root), device) if args.trace else None
    if spans:
        spans.install()
    try:
        cell.setup()
        if spans:
            spans.reset()
        rec = cell.window()
        rec["core"] = core
        # set-up is counted on the wall clock from the parent's start
        rec["setup_s"] = cell.setup_s
        if spans:
            rec["spans_ms"] = spans.totals_ms()
            rec["span_calls"] = spans.calls()
        dev = torch.device(device)
        rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                    if dev.type == "cuda" else 0)
        rec["device_kind"] = (torch.cuda.get_device_name(dev)
                              if dev.type == "cuda" else "cpu")
        rec["trace"] = cell.traced(spans) if spans else None
    finally:
        if spans:
            spans.remove()
    rec["checks"] = check.numbers(cell)
    rec["detail"] = cell.detail
    if args.control:
        rec["control"] = check.numbers(cell, control=True)
        rec["control_detail"] = cell.detail
    from compton2d_tpu_torch.transport import flight
    rec["flight_launches"] = flight.launch_counts()
    cell.close()
    return rec


# each rank's figures of the traced stretch, averaged over the ranks
RANK_TRACE = ("busy_s", "window_s", "profiled_s", "comm_kernel_s",
              "align_s")


def merge(recs: list) -> dict:
    """One record of the ranks': the slowest rank's window, set-up, spans
    and exchange; the fullest card's memory; the mean of the ranks'
    traced figures; each rank's core, set-up, window, host thread, peak
    memory and traced figures (``ranks``); each compared number's
    worst."""
    r0 = dict(recs[0])
    worst = lambda k: max(r[k] for r in recs)
    r0.update(window_s=worst("window_s"), setup_s=worst("setup_s"),
              comm_s=worst("comm_s"),
              memory_peak_bytes=worst("memory_peak_bytes"))
    if r0.get("spans_ms"):
        r0["spans_ms"] = {k: max(r["spans_ms"][k] for r in recs)
                          for k in r0["spans_ms"]}
    r0["ranks"] = [{"core": r["core"], "setup_s": r["setup_s"],
                    "run_window_s": r["window_s"], "host": r["host"],
                    "memory_peak_bytes": r["memory_peak_bytes"]}
                   for r in recs]
    if r0.get("trace"):
        mean = lambda k: sum(r["trace"][k] for r in recs) / len(recs)
        r0["trace"] = dict(r0["trace"], **{k: mean(k) for k in RANK_TRACE})
        for each, r in zip(r0["ranks"], recs):
            each.update({k: r["trace"][k] for k in RANK_TRACE})
    for key in ("checks", "control"):
        if key in r0:
            r0[key] = {k: max(r[key][k] for r in recs) for k in r0[key]}
    return r0


def metrics_of(bench: dict, cell: str, trace: bool, m,
               root: Path = specs.ROOT) -> dict:
    """The cell's metrics of BENCHMARK.json (end-to-end, or per-layer when
    traced), each from its reader; a reader that finds nothing to read
    leaves its metric out."""
    out = {}
    for spec in bench["per_layer" if trace else "end_to_end"]:
        if "workloads" in spec and cell not in spec["workloads"]:
            continue
        v = specs.load_metric(spec["name"], root).read(m)
        if v is not None:
            out[spec["name"]] = {"value": float(v), "unit": spec["unit"]}
    return out


def card_lines(n: int) -> list:
    """Each card's name, power limit and clocks as nvidia-smi reads them."""
    try:
        q = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return q.stdout.strip().splitlines()[:n]
    except (OSError, subprocess.SubprocessError) as e:
        return [f"nvidia-smi: {e}"]


def collect(args, device_type: str = "cuda", root: Path = specs.ROOT,
            before=None) -> dict:
    """The cell's record: of its one process, or merged over its ranks
    (each of which first calls ``before`` when given)."""
    w = specs.load_workload(args.workload, root)
    if int(w["ranks"]) == 1:
        return run_rank(args, torch.device(device_type, 0) if
                        device_type == "cuda" else torch.device("cpu"),
                        root=root)
    from harness import ranks as rk
    return merge(rk.run(args, int(w["ranks"]), w["backend"], device_type,
                        root, before))


def result(args, rec: dict, root: Path = specs.ROOT):
    """The last line's object and the lines before it: counts (standard
    output) and the compared numbers (standard error)."""
    from harness import check

    bench = specs.load_benchmark(root)
    w = specs.load_workload(args.workload, root)
    ranks = int(w["ranks"])
    cfg, _ = specs.sim_config(specs.load_config(w["config"], root), w,
                              args.seed)
    m = SimpleNamespace(cfg=cfg, workload=w, world=ranks, **{
        k: rec.get(k) for k in (
            "window_s", "units", "steps", "setup_s", "histories",
            "fp_substeps", "comm_s", "spans_ms", "trace")})
    limits, checks = w["limits"], rec["checks"]
    over = [k for k, v in checks.items()
            if not check.verdict({k: v}, limits)]
    info = {k: rec.get(k) for k in (
        "window_s", "units", "unit_ends_s", "steps", "histories",
        "fp_substeps", "rounds",
        "n_window", "n_straggler", "event_bytes", "memory_peak_bytes",
        "flight_launches", "span_calls", "core", "host")}
    if rec.get("trace"):
        info["trace_bytes"] = rec["trace"]["trace_bytes"]
        info["trace_profiled_s"] = rec["trace"]["profiled_s"]
    info["rounds_per_step"] = rec["rounds"] / rec["steps"]
    info["fp_substeps_per_step"] = rec["fp_substeps"] / rec["steps"]
    out_lines = ["# counts " + json.dumps(info)]
    out_lines.append("# detail " + json.dumps(rec.get("detail")))
    if rec.get("ranks"):
        out_lines.append("# ranks " + json.dumps(rec["ranks"]))
    if "control" in rec:
        out_lines.append("# control " + json.dumps(rec["control"]))
        out_lines.append("# control detail "
                         + json.dumps(rec["control_detail"]))
    device = {"platform": "gpu", "kind": rec["device_kind"], "count": ranks,
              "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    res = {"correct": not over, "attempted": len(checks),
           "failed": len(over),
           "metrics": metrics_of(bench, args.workload, bool(args.trace), m,
                                 root),
           "device": device}
    if args.trace:
        tr = rec["trace"]
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        res["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    res["checks"] = {k: {"value": v, "limit": limits.get(k)}
                     for k, v in checks.items()}
    err_lines = [f"check {k} {v!r} limit {limits.get(k)!r}"
                 for k, v in checks.items()]
    return res, out_lines, err_lines


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    w = specs.load_workload(args.workload)
    ranks = int(w["ranks"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < ranks:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {ranks} CUDA card(s), "
              f"found {n}", file=sys.stderr)
        return 2
    rec = collect(args)
    guard.check("before the result")
    res, out_lines, err_lines = result(args, rec)
    print("\n".join(out_lines + ["# cards " + json.dumps(card_lines(ranks))]),
          flush=True)
    print("\n".join(err_lines), file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
