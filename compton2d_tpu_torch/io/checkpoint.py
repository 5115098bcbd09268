"""The walltime guard of a long run (the port's copy of
``compton2d_tpu.io.checkpoint.WalltimeGuard``). Checkpoint files are not
ported yet."""
from __future__ import annotations

import time


class WalltimeGuard:
    """Self-checkpoint trigger at a fraction of the walltime budget
    (xec2d.f:50-55: 95 % of 8 h)."""

    def __init__(self, budget_s: float, frac: float = 0.95):
        self.t0 = time.time()
        self.budget_s = budget_s
        self.frac = frac

    def should_checkpoint(self) -> bool:
        if self.budget_s <= 0:
            return False
        return (time.time() - self.t0) >= self.frac * self.budget_s
