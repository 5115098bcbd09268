"""The port's checkpoint and resume: a run checkpointed by the walltime
guard after 2 steps and resumed in a fresh Simulation equals the
uninterrupted 4-step run bit for bit (every state tensor, the random
stream, each step's tallies, the event file), with and without pair
physics; the meta; and the refusals (another device type's random
stream, a state of other shapes)."""
import filecmp

import numpy as np
import pytest
import torch

from compton2d_tpu_torch import examples as pex
from compton2d_tpu_torch.driver import Simulation
from compton2d_tpu_torch.io.checkpoint import (
    load_checkpoint,
    load_meta,
    save_checkpoint,
)

torch.set_num_threads(2)

CONFIGS = {
    "corona": dict(nz=3, nr=2, nst=1500, n_slots=4096, num_nt=50, n_vol=48,
                   nphfield=48, t_const=False),
    "pair_corona": dict(nz=2, nr=2, nst=400, n_slots=2048, num_nt=40,
                        n_vol=32, nphfield=32, pair_switch=1, amxwl=0.5,
                        gmin=3.0, gmax=20.0),
}


def _tensors(state):
    """(name, tensor) of every tensor of a SimState, and the generator's
    state."""
    out = [("key", state.key.get_state())]
    for name in state._fields:
        leaf = getattr(state, name)
        if hasattr(leaf, "_fields"):
            out += [(f"{name}.{f}", getattr(leaf, f)) for f in leaf._fields]
        elif isinstance(leaf, torch.Tensor):
            out.append((name, leaf))
    return out


def _assert_tallies_equal(a, b, label):
    for f in a.tallies._fields:
        assert torch.equal(getattr(a.tallies, f), getattr(b.tallies, f)), \
            (label, f)
    assert torch.equal(a.events.data, b.events.data), label


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_resume_is_bitwise(tmp_path, config):
    kw = dict(CONFIGS[config], seed=5, device="cpu")
    whole = pex.small_corona(**kw).attach_outputs(str(tmp_path / "whole"))
    ref = [whole.step() for _ in range(4)]

    first = pex.small_corona(**kw).attach_outputs(str(tmp_path / "cut"))
    outs = [first.step() for _ in range(2)]
    ck = str(tmp_path / "ck" / "state.npz")
    assert first.run_to_stop(walltime_budget_s=1e-9, checkpoint_path=ck) \
        is False
    assert int(first.state.ncycle) == 2          # no step after the guard
    meta = load_meta(ck)
    assert meta["ncycle"] == 2 and meta["key_device"] == "cpu"
    assert meta["time"] == float(first.state.time)

    resumed = Simulation(first.cfg, first.zone_init, device="cpu")
    resumed.attach_outputs(str(tmp_path / "cut"), resume=True)
    resumed.state = load_checkpoint(ck, resumed.state)
    outs += [resumed.step() for _ in range(2)]
    for i, (a, b) in enumerate(zip(outs, ref)):
        _assert_tallies_equal(a, b, f"step {i}")
    for (name, a), (_, b) in zip(_tensors(resumed.state),
                                 _tensors(whole.state)):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert resumed.event_writer.n_written > 0
    assert filecmp.cmp(tmp_path / "cut" / "evb.dat",
                       tmp_path / "whole" / "evb.dat", shallow=False)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    sim = pex.small_corona(**CONFIGS["corona"], seed=2, device="cpu")
    sim.step()
    path = str(tmp_path_factory.mktemp("ck") / "state.npz")
    save_checkpoint(path, sim.state, {"ncycle": 1})
    return sim, path


def test_load_onto_another_device_type_raises(saved, tmp_path):
    """A CUDA generator's state is not a CPU generator's: a checkpoint
    whose random stream came from another device type is refused."""
    sim, path = saved
    with np.load(path) as data:
        arrays = dict(data)
    arrays["key_device"] = np.asarray("cuda")
    other = str(tmp_path / "cuda.npz")
    with open(other, "wb") as fh:
        np.savez(fh, **arrays)
    with pytest.raises(ValueError, match="cuda"):
        load_checkpoint(other, sim.state)
    # the file as written loads, and equals the state it came from
    back = load_checkpoint(path, sim.state)
    for (name, a), (_, b) in zip(_tensors(back), _tensors(sim.state)):
        assert torch.equal(a, b), name


def test_load_into_another_shape_raises(saved):
    _, path = saved
    other = pex.small_corona(**dict(CONFIGS["corona"], nz=4), seed=2,
                             device="cpu")
    with pytest.raises(ValueError, match="zones"):
        load_checkpoint(path, other.state)
