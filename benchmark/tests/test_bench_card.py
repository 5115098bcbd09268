"""The control on the card: the reference with TF32 on in the program's
place reads over the cells' limits, and the program itself under them,
on three seeds. The blob runs at the CPU tests' tiny size; the corona at
its own size, one cycle of its window (at 32x32 zones and 65536 slots
TF32 still moved no photon), on one card and on four. Needs a CUDA card
(four for the cell on four); skips without.

    python3 -m pytest benchmark/tests/test_bench_card.py
"""
import json

import pytest
import torch

from conftest import BENCH


def _needs_card(n=1):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA card(s)")


def _control_fails(root, cell, limits):
    import run as entry

    for seed in (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13):
        args = entry.parser().parse_args([
            "--workload", cell, "--seed", str(seed), "--seconds", "0",
            "--trace", "0", "--control", "1"])
        rec = entry.collect(args, "cuda", root)
        assert all(v <= limits[k] for k, v in rec["checks"].items()), rec
        assert any(v > limits[k] for k, v in rec["control"].items()), rec


@pytest.mark.cuda
def test_control_fails_on_the_blob(tiny_root):
    _needs_card()
    limits = json.loads((BENCH / "workloads" / "mrk421_dense.to_tstop.json")
                        .read_text())["limits"]
    path = tiny_root / "workloads" / "tiny_blob.run.json"
    w = json.loads(path.read_text())
    w["limits"] = limits
    path.write_text(json.dumps(w))
    _control_fails(tiny_root, "tiny_blob.run", limits)


@pytest.mark.cuda
@pytest.mark.parametrize("cell, cards", [("corona99.evolve", 1),
                                         ("corona99.ranks4", 4)])
def test_control_fails_on_the_corona(cell, cards):
    _needs_card(cards)
    limits = json.loads((BENCH / "workloads" / f"{cell}.json")
                        .read_text())["limits"]
    _control_fails(BENCH, cell, limits)
