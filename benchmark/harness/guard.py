"""The check that no module of JAX or of the JAX package is loaded.

A module counts by its top-level name, the part before the first dot,
compared whole: ``compton2d_tpu_torch`` passes and ``compton2d_tpu``
fails.
"""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "compton2d_tpu"})


def forbidden_modules(modules=None) -> list:
    """The loaded module names whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)


def check(stage: str, modules=None) -> None:
    """Raise SystemExit naming what was found at ``stage``."""
    found = forbidden_modules(modules)
    if found:
        print(f"benchmark: {stage}: forbidden modules loaded: "
              f"{', '.join(found)}", file=sys.stderr, flush=True)
        raise SystemExit(3)
