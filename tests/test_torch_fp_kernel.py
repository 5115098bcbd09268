"""The FP solve's substep loop: each zone's substeps independent of every
other zone's (on the CPU, the property the kernel rests on), and the
hand-written kernel ``csrc/fp_substeps.cu`` against its plain PyTorch
version (``fp.update.substep_loop_reference``) on a CUDA card
(``compare_fp``), with each term of the operator switched on and on the
states of the benchmark cells' two configurations.

The card tests need the card and skip without one. This file imports
neither jax nor the JAX package, so it also runs on a machine without
jax:

    python3 -m pytest --noconftest tests/test_torch_fp_kernel.py -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from compton2d_tpu_torch import compare_fp, kernel_build, roofline
from compton2d_tpu_torch import telemetry as tm
from compton2d_tpu_torch.compare_fp import fp_args, solve
from compton2d_tpu_torch.examples import mrk421, small_corona
from compton2d_tpu_torch.fp import update

torch.set_num_threads(2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    update.build()
    return torch.device("cuda")


def _to(x, device):
    """``x`` with every tensor inside it on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_to(v, device) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(_to(v, device) for v in x)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    return x


def _blob_args(device):
    """fp_step's arguments in the fifth step of the 10x4 blob at small
    widths: the zones then take 13 to 148 substeps."""
    sim = mrk421(nz=10, nr=4, nst=2000, n_slots=8192, num_nt=200, n_vol=64,
                 nphfield=64, n_e=2e6, device=device)
    return fp_args(sim, 5)[-1]


def _zones_apart(args, kw, groups):
    """fp_step on each group of zone indices alone, as the zone farm
    passes a slice (a (Zs, 1) grid with each zone's z-row, the whole
    grid's slab volume and validity): {zone: (result, group position,
    loop result)}."""
    zones, n_field, tables, vol = args[:4]
    nz, nr, num_nt = zones.f_nt.shape
    Z = nz * nr
    f32 = torch.float32
    dev = vol.device
    j_row = kw.get("j_row")
    if j_row is None:
        j_row = torch.arange(nz, dtype=f32, device=dev)[:, None].expand(
            nz, nr)
    slab_vol = kw.get("slab_vol")
    if slab_vol is None:
        slab_vol = torch.sum(vol.reshape(Z).to(f32)) / nz
    valid = kw.get("zone_valid")
    if valid is None:
        valid = torch.ones(nz, nr, dtype=torch.bool, device=dev)
    out = {}
    for idx in groups:
        sel = torch.as_tensor(idx, device=dev)

        def part(x):
            x = x.reshape((Z,) + tuple(x.shape[2:]))[sel]
            return x.reshape((len(idx), 1) + tuple(x.shape[1:]))

        a = (type(zones)(*[part(x) for x in zones]), part(n_field), tables,
             part(vol), *args[4:8], part(args[8]), *args[9:])
        k = {n: (part(v) if n in ("eloss_br", "dn_pp", "dne_pa", "dnp_pa")
                 and v is not None else v) for n, v in kw.items()}
        k.update(j_row=part(j_row), slab_vol=slab_vol, zone_valid=part(valid))
        res, sub, _ = solve(a, k)
        for pos, z in enumerate(idx):
            out[z] = (res, pos, sub)
    return out


def _by_count(count) -> list:
    """Zone indices grouped by their substep count."""
    count = count.cpu().numpy()
    return [np.flatnonzero(count == c).tolist() for c in np.unique(count)]


def _done_zone_gaps(args, kw, count):
    """On the CPU, the plain loop over the whole grid against the plain
    loop on each group of zones that take the same number of substeps, in
    which no zone is done before the loop ends: whether n_e, kT_e and the
    distributions are equal bit for bit, and the largest relative gap of
    the positrons (which the whole grid's later substeps still feed with
    pair sources at d_t = 1e-30)."""
    args, kw = _to(args, "cpu"), _to(kw, "cpu")
    whole, _, _ = solve(args, kw)
    zones = whole.zones
    nz, nr, num_nt = zones.f_nt.shape
    apart = _zones_apart(args, kw, _by_count(count))
    same = {"n_e": True, "tea": True, "f_nt": True}
    npos = 0.0
    for z, (res, pos, _) in apart.items():
        for name in same:
            w = getattr(zones, name).reshape(nz * nr, -1)[z]
            g = getattr(res.zones, name).reshape(-1, w.shape[-1])[pos]
            same[name] &= torch.equal(w, g)
        w = zones.n_pos.reshape(nz * nr, num_nt)[z].double()
        g = res.zones.n_pos.reshape(-1, num_nt)[pos].double()
        npos = max(npos, float(torch.sum(torch.abs(w - g))
                               / torch.clamp_min(torch.sum(torch.abs(w)),
                                                 1e-300)))
    return same, npos


def test_zone_substeps_counted_beside_the_largest_count():
    """The step's two counts come from one ``fp.done`` read at its end:
    ``fp.zone_substeps`` the per-zone counts summed, ``fp.substeps`` the
    largest; the plain loop reads its condition after each substep but
    the first. The kernel's bound charges the zone-substeps run, the
    step's (the benchmark's model) every zone the largest count."""
    args, kw = _blob_args("cpu")
    tm.reset()
    tm.enable()
    try:
        res, sub, _ = solve(args, kw)
        snap = tm.snapshot()
    finally:
        tm.disable()
        tm.reset()
    count = sub.count.tolist()
    Z, num_nt = len(count), args[0].f_nt.shape[-1]
    assert snap["counts"] == {"fp.substeps": max(count),
                              "fp.zone_substeps": sum(count)}
    assert int(res.substeps) == max(count)
    assert snap["reads"]["fp.done"]["count"] == max(count) + 1
    kernel = roofline.fp_kernel_bound(Z, num_nt, sum(count))
    step = roofline.fp_bound(Z, num_nt, args[1].shape[-1], max(count))
    assert kernel["ops"] == sum(count) * num_nt * roofline.FP_OPS_BIN_SUBSTEP
    assert sum(count) < max(count) * Z
    assert kernel["ops"] < step["ops"] - Z * 2 * args[1].shape[-1] * num_nt


@pytest.mark.parametrize("fault", ["device", "dtype", "shape", "strides"])
def test_kernel_operands_off_their_form_raise(fault):
    """The kernels' wrappers refuse an operand on another device, of
    another dtype or shape, or not contiguous (``kernel_build.check``)."""
    t = torch.zeros(4, 6)
    want = dict(name="f", dtype=torch.float32, shape=(4, 6),
                device=torch.device("cpu"))
    kernel_build.check(t, **want)
    if fault == "device":
        want["device"] = torch.device("cuda", 0)
    elif fault == "dtype":
        t = t.double()
    elif fault == "shape":
        t = t.reshape(6, 4)
    else:
        t = torch.zeros(6, 4).t()
    with pytest.raises(ValueError):
        kernel_build.check(t, **want)


def test_zones_solve_independently_of_each_other():
    """fp_step on the 10x4 blob's zones one zone at a time, each as the
    zone farm passes it, equals the whole grid bit for bit (f_nt, tea,
    n_e, incomplete), and the whole grid's substeps are the largest
    single-zone count: so a zone that is done is left as it is by the
    substeps the other zones still take."""
    args, kw = _blob_args("cpu")
    whole, sub, _ = solve(args, kw)
    zones = whole.zones
    nz, nr, num_nt = zones.f_nt.shape
    Z = nz * nr
    count = sub.count.tolist()
    assert min(count) < max(count)       # some zones are done early
    apart = _zones_apart(args, kw, [[z] for z in range(Z)])
    incomplete = 0
    for z, (res, _, one) in apart.items():
        assert int(res.substeps) == count[z] == int(one.count[0]), z
        incomplete += int(res.incomplete)
        for name in ("f_nt", "tea", "n_e"):
            w = getattr(zones, name).reshape(Z, -1)[z]
            g = getattr(res.zones, name).reshape(-1)
            assert torch.equal(w, g), (name, z)
    assert int(whole.substeps) == max(count)
    assert int(whole.incomplete) == incomplete


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _physics(sim, **kw):
    p = sim.cfg.physics
    inj = kw.pop("injection", None)
    if inj:
        kw["injection"] = dataclasses.replace(p.injection, **inj)
    return sim.with_config(dataclasses.replace(
        sim.cfg, physics=dataclasses.replace(p, **kw)))


CORONA = dict(nz=3, nr=2, nst=3000, n_slots=4096, num_nt=50, n_vol=64,
              nphfield=64)
BLOB = dict(nz=4, nr=2, nst=1500, n_slots=8192, num_nt=160, n_vol=64,
            nphfield=64, n_e=2e6)


def _term_args(term: str, device):
    """fp_step's (args, kwargs) in the third step of a small configuration
    with ``term`` switched on."""
    if term == "bremsstrahlung":
        sim = _physics(small_corona(**CORONA, device=device),
                       fp_include_bremsstrahlung=True)
    elif term == "pickup":
        sim = _physics(small_corona(**CORONA, device=device),
                       injection=dict(pickup=True, pickup_rate=1e4))
    elif term == "gauss_injection":
        sim = _physics(small_corona(**CORONA, device=device), injection=dict(
            switch=1, distribution=1, luminosity=1e40, gauss_g=5.0,
            gauss_sigma=1.0))
    elif term == "power_law_injection":
        sim = mrk421(**BLOB, device=device)
    elif term == "g2var_switch":
        sim = _physics(mrk421(**BLOB, device=device),
                       injection=dict(g2var_switch=1))
    elif term in ("coulomb_tables", "coulomb_drift"):
        sim = small_corona(**CORONA, fp_include_coulomb=True, device=device)
    elif term == "pair_switch":
        sim = small_corona(nz=2, nr=2, nst=400, n_slots=2048, num_nt=40,
                           n_vol=32, nphfield=32, pair_switch=1, amxwl=0.5,
                           gmin=3.0, gmax=20.0, device=device)
    else:
        sim = small_corona(**CORONA, device=device)
    args, kw = fp_args(sim, 3)[-1]
    if term == "coulomb_drift":
        kw = dict(kw, coulomb=None)
    if term == "zone_farm_slice":
        # a slice of 5 zones and one pad zone, as fp_zone_farm passes it
        zones, n_field, tables, vol = args[:4]
        nz, nr = zones.tea.shape
        valid = torch.ones(nz, nr, dtype=torch.bool, device=device)
        valid[-1, -1] = False
        zones = zones._replace(n_e=torch.where(valid, zones.n_e, 0.0),
                               tna=torch.where(valid, zones.tna, 0.0))
        j_row = torch.arange(nz, dtype=torch.float32, device=device)[
            :, None].expand(nz, nr)
        args = (zones,) + args[1:]
        kw = dict(kw, j_row=j_row, slab_vol=torch.sum(vol) / (nz + 1),
                  zone_valid=valid)
    return args, kw


def _compare(args, kw, label: str):
    """The kernel's fp_step against the plain loop's on the card
    (``compare_fp.compare``): equal per-zone substep counts and incomplete
    zones, te and f_nt within ``compare_fp.GAP`` (the check's measures),
    one kernel launch; the zones whose counts differ are printed. Returns
    the per-zone counts."""
    c = compare_fp.compare(args, kw)
    print(compare_fp.describe(c, label))
    assert compare_fp.departures(c) == []
    return c.count


TERMS = ("base", "bremsstrahlung", "pickup", "gauss_injection",
         "power_law_injection", "g2var_switch", "coulomb_tables",
         "coulomb_drift", "pair_switch", "zone_farm_slice")


@pytest.mark.cuda
@pytest.mark.parametrize("term", TERMS)
def test_kernel_against_plain_loop_with_each_term(card, term):
    args, kw = _term_args(term, card)
    count = _compare(args, kw, term)
    if term == "pair_switch":
        same, npos = _done_zone_gaps(args, kw, count)
        print(f"pair_switch: done zones stopped: {same}, positrons' largest "
              f"gap {npos:.3e}")
        assert same["n_e"]


@pytest.mark.cuda
@pytest.mark.parametrize("name, steps", [("mrk421", 6),
                                         ("large_corona", 1)])
def test_kernel_against_plain_loop_on_cell_states(card, name, steps):
    """Each cell's configuration from its state after its set-up steps
    (the Mrk 421 run from t = 0, its first six steps): the kernel against
    the plain loop on each step's fp_step inputs, and on the CPU the done
    zones' later substeps of the plain loop leave n_e bit for bit as it
    is. The steps themselves launch the kernel once each."""
    sim, setup = compare_fp.cell_sim(name, card)
    for _ in range(setup):
        sim.step()
    update.reset_launch_counts()
    recorded = fp_args(sim, steps)
    assert update.launch_counts()["fp_substeps"] == len(recorded) == steps
    for i, (args, kw) in enumerate(recorded):
        count = _compare(args, kw, f"{name} step {setup + i}")
        if int(count.min()) < int(count.max()):
            same, _ = _done_zone_gaps(args, kw, count)
            print(f"{name} step {setup + i}: done zones stopped: {same}")
            assert same["n_e"]
