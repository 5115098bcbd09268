"""Spans around the calls into each layer, recorded from the benchmark's
own files: each (module, attribute) a layer names is replaced by a
wrapper for the length of a run and put back after it.

On a card a span is a pair of CUDA events on the current stream, read
after the window: nothing synchronises inside it. A call into a layer
that is already open (``fp_zone_farm`` calling ``fp_step``) opens no
second span, so a layer's time is the union of its outermost calls. The
stack of open spans names what the host is doing, for the profiler's
idle gaps (``torch.profiler.record_function`` while a profiler runs).
"""
from __future__ import annotations

import functools
import importlib
import time
from typing import Dict, List, Tuple

import torch


def _resolve(module: str, attr: str):
    """The object that owns ``attr`` (a module, or a class for
    ``Class.method``) and the attribute's last name."""
    owner = importlib.import_module(module)
    *path, name = attr.split(".")
    for p in path:
        owner = getattr(owner, p)
    return owner, name


class Spans:
    """Wraps every span of ``layers`` ({layer: [(module, attribute)]}) on
    ``install`` and restores them on ``remove``."""

    def __init__(self, layers: Dict[str, List[Tuple[str, str]]], device):
        self.layers = layers
        self.cuda = torch.device(device).type == "cuda"
        self.depth = {k: 0 for k in layers}
        self.open: List[str] = []          # the host's open spans
        self.marks: Dict[str, list] = {k: [] for k in layers}
        self.profiling = False
        self._saved = []

    def _wrap(self, layer: str, fn):
        @functools.wraps(fn)
        def span(*args, **kw):
            if self.depth[layer]:
                return fn(*args, **kw)
            self.depth[layer] += 1
            self.open.append(layer)
            rf = (torch.profiler.record_function(f"span:{layer}")
                  if self.profiling else None)
            if rf is not None:
                rf.__enter__()
            start = self._mark()
            try:
                return fn(*args, **kw)
            finally:
                self.marks[layer].append((start, self._mark()))
                if rf is not None:
                    rf.__exit__(None, None, None)
                self.open.pop()
                self.depth[layer] -= 1
        return span

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def install(self) -> "Spans":
        for layer, pairs in self.layers.items():
            for module, attr in pairs:
                owner, name = _resolve(module, attr)
                fn = owner.__dict__[name] if isinstance(owner, type) \
                    else getattr(owner, name)
                self._saved.append((owner, name, fn))
                setattr(owner, name, self._wrap(layer, fn))
        return self

    def remove(self) -> None:
        while self._saved:
            owner, name, fn = self._saved.pop()
            setattr(owner, name, fn)

    def reset(self) -> None:
        for v in self.marks.values():
            v.clear()

    def totals_ms(self) -> Dict[str, float]:
        """Each layer's milliseconds since the last ``reset`` (the card
        synchronised first)."""
        if self.cuda:
            torch.cuda.synchronize()
        out = {}
        for layer, pairs in self.marks.items():
            if self.cuda:
                out[layer] = sum(a.elapsed_time(b) for a, b in pairs)
            else:
                out[layer] = 1e3 * sum(b - a for a, b in pairs)
        return out

    def calls(self) -> Dict[str, int]:
        return {k: len(v) for k, v in self.marks.items()}
