"""Spans, host reads and counters inside the port's step, off by default.

The whole interface is :func:`enable`, :func:`disable`, :func:`reset`,
:func:`enabled` and :func:`snapshot`, and the three recorders the program
calls:

- ``with span(name):`` a stretch of the step. Off, it returns one shared
  no-op object: no clock is read, no event recorded, nothing allocated.
  On, it reads the host's ``perf_counter_ns`` at both ends and, once CUDA
  is up, records a pair of CUDA events on the current stream; nothing
  synchronises inside it (``snapshot`` synchronises once and reads the
  events). While a ``torch.profiler`` records, it also enters
  ``record_function("span:" + name)``.
- ``read(site, value, kind)``: every point of the step where the host
  waits for the card: a read of a result (``kind`` is ``bool``, ``int``,
  ``float`` or :func:`to_host`), a call that reads a size back
  (``torch.nonzero``, ``torch.bincount``), or a copy from pageable host
  memory onto the card, which waits for the stream. Off, it is
  ``kind(value)``; on, it also counts the read at ``site`` and adds the
  host's nanoseconds blocked in it.
- ``count(name, n)``: a count (FP substeps, tracking rounds, loop
  iterations). A tensor ``n`` stays on the card, unread, until the
  snapshot adds it up; a step computes such a count only while
  :func:`enabled`, so off it costs the step nothing.

A kernel module hands its launch counts over once, when it is imported,
with :func:`register_launches`; the snapshot reads them.

``enable`` takes one anchor pair, ``(time.time_ns(),
time.perf_counter_ns())``: the snapshot puts each span's host intervals
on the Unix clock from it, the clock of a ``torch.profiler`` chrome trace
(``baseTimeNanoseconds`` + ``ts``), so the program's spans can label a
trace recorded without any ``record_function``.

Names used by the step (``driver``, ``transport``, ``fp``, ``io``,
``parallel``, ``run_mrk421``):

- spans: ``step`` (all of ``Simulation.step``) with ``step.census``,
  ``step.zone_pass``, ``step.source``, ``step.pairs`` (with
  ``pairs.field``, the census histogram on the gamma-gamma grid and its
  scaling, ``pairs.fit``, ``nph_smooth``, and ``pairs.rates``, the
  opacity, pair production and annihilation rates), ``step.track``
  (with ``track.tables``, ``track.flight``, ``track.leak``,
  ``track.scatter``), ``step.fp`` and ``step.outputs``; ``run.finalize``,
  ``outputs.read_events``, ``outputs.postprocess``, ``mesh.exchange``;
- read sites: ``fp.done`` (on the card the step's substep counts, once
  a step; on the CPU the plain substep loop's condition),
  ``census.trigger``, ``segment.lengths``, ``track.more`` (the round
  loop's condition), ``track.it_used``, ``track.leak``,
  ``track.scatter``, ``track.seed``, ``scatter.lanes``, ``leak.lanes``,
  ``loop.more``, ``loop.leak``, ``loop.scatter``,
  ``step.clock``, ``step.dt``, ``step.events``, ``step.outputs``,
  ``outputs.events``, ``run.finalize``, ``mesh.buffer``;
- counts: ``fp.substeps`` (the step's largest per-zone count of FP
  substeps), ``fp.zone_substeps`` (the per-zone counts summed over the
  zones), ``track.rounds``, ``loop.iterations``, and on the card until
  the snapshot ``pairs.fit_zones`` (the zones ``nph_smooth`` fits rather
  than leaves raw, on a rank its zone slice) and ``pairs.gg_photons``
  (the live census photons on the gamma-gamma grid, on a rank its own);
- launches (the snapshot's, counted whether on or off, by the kernel
  modules): ``transport.flight.launch_counts()`` (``inline``, ``strat``,
  ``pair``, ``window``, ``global_tables``) and
  ``fp.update.launch_counts()`` (``fp_substeps``).
"""
from __future__ import annotations

import time

import torch

_on = False
_anchor = (0, 0)            # (time.time_ns(), time.perf_counter_ns())
_spans: dict = {}           # name -> [(t0_ns, t1_ns, event0, event1)]
_reads: dict = {}           # site -> [count, ns blocked]
_counts: dict = {}          # name -> total
_card_counts: dict = {}     # name -> [tensors], added up by the snapshot
_launches: dict = {}        # kernel module -> its launch_counts


class _Off:
    """The shared span of telemetry off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Span:
    __slots__ = ("name", "t0", "e0", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.profiler.record_function("span:" + self.name)
            self.rf.__enter__()
        else:
            self.rf = None
        self.e0 = _event()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        e1 = _event()
        _spans.setdefault(self.name, []).append((self.t0, t1, self.e0, e1))
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def _event():
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def span(name: str):
    """A context manager around a stretch of the step (module docstring)."""
    return _Span(name) if _on else OFF


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host: the ``kind`` of a tensor read."""
    return t.cpu()


def read(site: str, value, kind):
    """``kind(value)``, counted at ``site`` with its host wait when on."""
    if not _on:
        return kind(value)
    t0 = time.perf_counter_ns()
    out = kind(value)
    dt = time.perf_counter_ns() - t0
    r = _reads.get(site)
    if r is None:
        _reads[site] = [1, dt]
    else:
        r[0] += 1
        r[1] += dt
    return out


def count(name: str, n) -> None:
    """Add ``n`` to the count ``name`` when on: an int at once, a tensor
    (kept as it is, not read) at the snapshot."""
    if not _on:
        return
    if isinstance(n, torch.Tensor):
        _card_counts.setdefault(name, []).append(n)
    else:
        _counts[name] = _counts.get(name, 0) + int(n)


def enabled() -> bool:
    """Whether the recorders record: a count that costs the step work
    of its own is computed only then."""
    return _on


def register_launches(module: str, launch_counts) -> None:
    """Have the snapshot's ``launches`` hold what ``launch_counts()``
    (a kernel module's launches by name, a dict) reads then."""
    _launches[module] = launch_counts


def enable() -> None:
    """Start recording (the records kept so far stay) and take the clock
    anchor."""
    global _on, _anchor
    _anchor = (time.time_ns(), time.perf_counter_ns())
    _on = True


def disable() -> None:
    """Stop recording; the records stay until :func:`reset`."""
    global _on
    _on = False


def reset() -> None:
    """Drop every record."""
    _spans.clear()
    _reads.clear()
    _counts.clear()
    _card_counts.clear()


def snapshot() -> dict:
    """The records, by name (the card synchronised once first):

    - ``spans``: each span's ``calls``, ``host_ms``, ``device_ms`` (None
      without CUDA events) and ``intervals``, its host intervals as
      [start, end] nanoseconds on the Unix clock;
    - ``reads``: each site's ``count`` and ``wait_ms``;
    - ``counts``, those kept on the card read here;
      ``launches``: the registered kernel modules' launch
      counts as they read;
    - ``anchor``: the (Unix ns, perf_counter ns) pair of ``enable``.
    """
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    unix0, perf0 = _anchor
    spans = {}
    for name, marks in _spans.items():
        timed = all(e0 is not None and e1 is not None
                    for _, _, e0, e1 in marks)
        spans[name] = {
            "calls": len(marks),
            "host_ms": sum(t1 - t0 for t0, t1, _, _ in marks) * 1e-6,
            "device_ms": (sum(e0.elapsed_time(e1) for _, _, e0, e1 in marks)
                          if timed else None),
            "intervals": [[unix0 + t0 - perf0, unix0 + t1 - perf0]
                          for t0, t1, _, _ in marks],
        }
    counts = dict(_counts)
    for name, ts in _card_counts.items():
        counts[name] = counts.get(name, 0) + int(torch.stack(ts).sum())
    return {
        "spans": spans,
        "reads": {k: {"count": c, "wait_ms": ns * 1e-6}
                  for k, (c, ns) in _reads.items()},
        "counts": counts,
        "launches": {k: n for counts in _launches.values()
                     for k, n in counts().items()},
        "anchor": [unix0, perf0],
    }
