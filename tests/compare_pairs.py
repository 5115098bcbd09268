"""Port against reference on the bounded-tail corona, on the CPU.

A helper, not a test file (tests/test_torch_pairs.py imports its
``fp_args``, ``port_cc_limit`` and ``reference_fp``). Three comparisons,
each printed line by line:

``te``
    pairs off, nst 400, 2048 slots: mean Te after each of 3 steps on the
    reference's XLA tracking path, on it with the flight kernel's
    exhaustion rule patched into its rejection sampler
    (``jax_scatter_draws.kernel_exhaustion_rule``), on its Pallas path
    (interpret mode), on the port's flight kernel (its plain version) and
    on the port's lock-step loop, over ``--seeds``;
``trajectory``
    pairs on, 4x3 zones, nst 3000, 8192 slots: per step the audit, Te
    range, dn_pp, positron density and pair fraction of the reference
    (Pallas path) and of the port, over ``--seeds``;
``fp``
    the port's FP inputs at step ``--step`` of that trajectory (seed 0;
    ``--size tiny``: the 2x2 pair corona of tests/test_torch_pairs.py)
    through the reference's ``fp_step`` as it is, with the port's
    Chang-Cooper limits below w = -500 patched in, with the pair terms of
    the two end bins zeroed, and with both; and through the port's
    ``fp_step``: the pair fraction and Te per zone of each, and each
    one's largest difference from the port relative to the port's max;
``precision``
    the port's pair corona (4x3 zones, seed 0) for ``--steps`` steps with
    its ``fp_step`` in float32, as it runs, and again in float64 (the
    arguments and tables cast up, the results cast back): per step the
    largest pair fraction and positron density of both trajectories, and
    the float64 solve on the float32 run's own inputs of that step;
``deck``
    the reference-format deck ``--deck`` (the port's ``decks``) at full
    width (GridConfig's defaults, as on the card) with ``--slots`` slots
    and nst ``--nst``, written once and loaded by each package's legacy
    importer: per step the audit, Te range, mean Te, FP substeps and
    dT_max of the reference (XLA tracking path, at the port's energy
    unit) and of the port's plain CPU path, over ``--seeds``;
``coulomb``
    the main path's corona at full width (8x4 zones, 200 gamma and 400
    energy bins, as on the card) with ``--slots`` slots and nst ``--nst``,
    with the Coulomb FP drift on and then off: per step the mean Te, the
    mean Te of each z row, the FP substeps and the audit of the reference
    (Pallas path, interpret mode) and of the port, over ``--seeds``.

Run from the repository root::

    JAX_PLATFORMS=cpu python tests/compare_pairs.py te --seeds 0 1 2
    JAX_PLATFORMS=cpu python tests/compare_pairs.py trajectory --steps 6
    JAX_PLATFORMS=cpu python tests/compare_pairs.py fp --step 3
    JAX_PLATFORMS=cpu python tests/compare_pairs.py fp --step 1 --size tiny
    python tests/compare_pairs.py precision --steps 8
    JAX_PLATFORMS=cpu python tests/compare_pairs.py deck --deck ec_deck
    JAX_PLATFORMS=cpu python tests/compare_pairs.py coulomb --seeds 0 \
        --steps 6 --slots 16384 --nst 6000
"""
import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

TINY = dict(nz=2, nr=2, nst=400, n_slots=2048, num_nt=40, n_vol=32,
            nphfield=32, t_const=False, amxwl=0.5, gmin=3.0, gmax=20.0)
MID = dict(nz=4, nr=3, nst=3000, n_slots=8192, num_nt=100, n_vol=128,
           nphfield=128, t_const=False, pair_switch=1, amxwl=0.5, gmin=3.0,
           gmax=20.0)
SIZES = {"tiny": dict(TINY, pair_switch=1), "mid": MID}


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x,
                      np.float64)


def _reference(cfg, pallas: str):
    from compton2d_tpu import examples as jex

    sim = jex.small_corona(**cfg, seed=0)
    return sim.with_config(dataclasses.replace(
        sim.cfg, run=dataclasses.replace(sim.cfg.run,
                                         pallas_tracking=pallas)))


def _runs(cfg, seeds, steps):
    """(label, seed, sim) after each step: reference (Pallas), port."""
    import jax

    from compton2d_tpu_torch import examples as pex

    ref = _reference(cfg, "on")
    init = ref.state
    for s in seeds:
        ref.state = init._replace(key=jax.random.PRNGKey(s))
        for i in range(steps):
            ref.step()
            yield "reference", s, i, ref
        port = pex.small_corona(**cfg, seed=s, device="cpu")
        for i in range(steps):
            port.step()
            yield "port", s, i, port


def te(seeds, steps):
    import contextlib

    import jax

    from compton2d_tpu_torch import examples as pex
    from jax_scatter_draws import kernel_exhaustion_rule

    for label, pallas, patch in (
            ("reference XLA", "off", contextlib.nullcontext),
            ("reference XLA with the kernel's exhaustion rule", "off",
             kernel_exhaustion_rule),
            ("reference Pallas", "on", contextlib.nullcontext)):
        with patch():
            sim = _reference(TINY, pallas)
            init = sim.state
            for s in seeds:
                sim.state = init._replace(key=jax.random.PRNGKey(s))
                _print_te(label, s, sim, steps)
    for label, tracker in (("port", "on"), ("port loop", "off")):
        for s in seeds:
            sim = pex.small_corona(**TINY, seed=s, device="cpu")
            sim = sim.with_config(dataclasses.replace(
                sim.cfg, run=dataclasses.replace(sim.cfg.run,
                                                 pallas_tracking=tracker)))
            _print_te(label, s, sim, steps)


def _print_te(label, seed, sim, steps):
    tes = []
    for _ in range(steps):
        sim.step()
        tes.append(float(np.mean(_np(sim.state.zones.tea))))
    print(label, seed, " ".join(f"{t:.1f}" for t in tes), flush=True)


def trajectory(seeds, steps):
    for label, s, i, sim in _runs(MID, seeds, steps):
        a, st = sim.energy_audit(), sim.state
        z = st.zones
        print(f"{label} seed {s} step {i}: balance {a['balance']:.6f} Te "
              f"{_np(z.tea).min():.1f}-{_np(z.tea).max():.1f} keV dn_pp "
              f"max {_np(st.dn_pp).max():.3e} n_pos max "
              f"{_np(z.n_pos).max():.3e} f_pair max "
              f"{_np(z.f_pair).max():.3e}", flush=True)


def fp_args(cfg, steps):
    """The arguments (args, kwargs) of the port's fp_step at each of the
    first ``steps`` steps of ``small_corona(**cfg)``, seed 0, on the CPU."""
    from compton2d_tpu_torch import driver
    from compton2d_tpu_torch import examples as pex

    seen = []
    port_fp = driver.fp_step

    def keep(*a, **k):
        seen.append((a, k))
        return port_fp(*a, **k)

    driver.fp_step = keep
    try:
        sim = pex.small_corona(**cfg, seed=0, device="cpu")
        for _ in range(steps):
            sim.step()
    finally:
        driver.fp_step = port_fp
    return seen


def port_cc_limit(w):
    """The port's w / (e^w - 1) (fp/chang_cooper.py) in jax, to patch
    over the reference's ``_w_over_expm1``: its limit -w below w = -500,
    where the reference keeps w = -500."""
    import jax.numpy as jnp

    wc = jnp.clip(w, -500.0, 500.0)
    small = jnp.abs(wc) < 1e-8
    safe = jnp.where(small, 1.0, wc)
    out = jnp.where(small, 1.0 - 0.5 * wc, safe / jnp.expm1(safe))
    return jnp.where(w < -500.0, -w, out)


def reference_fp(jsim, args, kw, end_bins: bool = True):
    """The reference's fp_step on the port's fp_step arguments, with the
    reference's tables; without ``end_bins``, the pair terms of the two
    end bins are zeroed first."""
    import jax.numpy as jnp

    from compton2d_tpu.fp.update import fp_step as j_fp_step
    from compton2d_tpu.state import ZoneState as JZones

    zones, n_field, _, vol, z_max, dz, dt, time, eloss_sy = args[:9]

    def J(t):
        return jnp.asarray(t.numpy())

    pair = {}
    for name in ("dn_pp", "dne_pa", "dnp_pa"):
        x = kw[name].numpy().copy()
        if not end_bins:
            x[..., 0] = x[..., -1] = 0.0
        pair[name] = jnp.asarray(x)
    jz = JZones(**{f: J(getattr(zones, f)) for f in JZones._fields})
    return j_fp_step(jz, J(n_field), jsim.tables, J(vol), z_max, J(dz),
                     J(dt), J(time), J(eloss_sy), jsim.cfg.physics,
                     jsim.scales, eloss_br=J(kw["eloss_br"]), **pair)


def fp(step, size):
    import compton2d_tpu.fp.chang_cooper as jcc
    from compton2d_tpu import examples as jex
    from compton2d_tpu_torch.fp.update import fp_step as p_fp_step

    cfg = SIZES[size]
    a, k = fp_args(cfg, step + 1)[step]
    jsim = jex.small_corona(**cfg)
    port = p_fp_step(*a, **k).zones

    def show(label, z):
        diff = {q: np.max(np.abs(_np(getattr(z, q)) - _np(getattr(port, q))))
                / max(np.max(np.abs(_np(getattr(port, q)))), 1e-300)
                for q in ("f_nt", "n_pos", "f_pair", "tea")}
        print(label, "f_pair", _np(z.f_pair).ravel(), "Te",
              _np(z.tea).ravel(), "differences from the port",
              " ".join(f"{q} {v:.3e}" for q, v in diff.items()))

    print("input f_pair", _np(a[0].f_pair).ravel(), "end-bin dn_pp",
          _np(k["dn_pp"])[..., 0].ravel(), _np(k["dn_pp"])[..., -1].ravel())
    show("reference", reference_fp(jsim, a, k).zones)
    show("reference without the end-bin terms",
         reference_fp(jsim, a, k, end_bins=False).zones)
    clipped = jcc._w_over_expm1
    jcc._w_over_expm1 = port_cc_limit
    try:
        show("reference with the port's limits",
             reference_fp(jsim, a, k).zones)
        show("reference with both repairs",
             reference_fp(jsim, a, k, end_bins=False).zones)
    finally:
        jcc._w_over_expm1 = clipped
    show("port", port)


def _cast(x, dtype):
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.to(dtype)
    if hasattr(x, "_fields"):
        return x._replace(**{f: _cast(getattr(x, f), dtype)
                             for f in x._fields})
    return x


def fp_float64(*a, **k):
    """The port's fp_step in float64 on float32 arguments (the tables cast
    up as well); the result cast back to float32."""
    from compton2d_tpu_torch.fp.update import fp_step as p_fp_step

    f64 = torch.float64
    tables = a[2]
    tables = tables._replace(gnt=_cast(tables.gnt, f64),
                             f_ic=_cast(tables.f_ic, f64),
                             gamma_bar=_cast(tables.gamma_bar, f64))
    args = [_cast(x, f64) for x in a]
    args[2] = tables
    res = p_fp_step(*args, **{n: _cast(v, f64) for n, v in k.items()})
    return _cast(res, torch.float32)


def precision(steps):
    from compton2d_tpu_torch import driver
    from compton2d_tpu_torch import examples as pex

    runs = {}
    port_fp = driver.fp_step
    for label, fn in (("float32", port_fp), ("float64", fp_float64)):
        same_input = []

        def fp(*a, _fn=fn, **k):
            res = _fn(*a, **k)
            if _fn is port_fp:
                same_input.append((fp_float64(*a, **k).zones, res.zones))
            return res

        driver.fp_step = fp
        try:
            sim = pex.small_corona(**MID, seed=0, device="cpu")
            rows = []
            for i in range(steps):
                sim.step()
                z = sim.state.zones
                rows.append((_np(z.f_pair).max(), _np(z.n_pos).max(),
                             _np(z.tea).min(), _np(z.tea).max()))
        finally:
            driver.fp_step = port_fp
        runs[label] = (rows, same_input)
    for i in range(steps):
        line = [f"step {i}:"]
        for label in ("float32", "float64"):
            fpair, npos, t0, t1 = runs[label][0][i]
            line.append(f"{label} f_pair max {fpair:.4e} n_pos max "
                        f"{npos:.4e} Te {t0:.1f}-{t1:.1f}")
        z64, z32 = runs["float32"][1][i]
        rel = (np.max(np.abs(_np(z64.f_pair) - _np(z32.f_pair)))
               / max(_np(z32.f_pair).max(), 1e-300))
        line.append(f"float64 solve on the float32 inputs: f_pair max "
                    f"{_np(z64.f_pair).max():.4e}, largest difference "
                    f"{rel:.3e} of the float32 max")
        print(" | ".join(line), flush=True)


def deck(name, seeds, steps, n_slots, nst):
    import tempfile

    import jax

    from compton2d_tpu.driver import Simulation as JSim
    from compton2d_tpu.io import legacy as jleg
    from compton2d_tpu_torch import decks
    from compton2d_tpu_torch.driver import Simulation as PSim

    run = dict(n_slots=n_slots, event_capacity=n_slots)
    # the spectrum files are read when a Simulation is made
    with tempfile.TemporaryDirectory() as d:
        lc = decks.load_deck(name, d, nst=nst, **run)
        port = PSim(lc.cfg, lc.zones, device="cpu")
        # the port's energy unit: the reference's own takes a file ring
        # (tbb = -1) as a 1 keV blackbody (ROADMAP section C)
        jlc = jleg.load_legacy_config(
            d, pallas_tracking="off", energy_scale=port.scales.E,
            adaptive_dt=(name == "disk_deck"), **run)
        ref = JSim(jlc.cfg, jlc.zones)
        ports = [PSim(lc.cfg.replace(run=dataclasses.replace(
            lc.cfg.run, seed=s)), lc.zones, device="cpu") for s in seeds]
    init = ref.state
    for s, port in zip(seeds, ports):
        ref.state = init._replace(key=jax.random.PRNGKey(s))
        for label, sim in (("reference", ref), ("port", port)):
            for i in range(steps):
                out = sim.step()
                tea = _np(sim.state.zones.tea)
                print(f"{name} {label} seed {s} step {i}: balance "
                      f"{sim.energy_audit()['balance']:.6f} Te "
                      f"{tea.min():.2f}-{tea.max():.2f} keV mean "
                      f"{tea.mean():.2f} FP substeps "
                      f"{int(_np(out.fp_substeps))} dT_max "
                      f"{float(_np(out.dT_max)):.4f} dt "
                      f"{float(_np(sim.state.dt)):.6e} s", flush=True)


def coulomb(seeds, steps, n_slots, nst):
    import jax

    from compton2d_tpu_torch import examples as pex

    cfg = dict(nz=8, nr=4, nst=nst, n_slots=n_slots, num_nt=200, n_vol=400,
               nphfield=400, t_const=False, max_flight_iters=256)
    for on in (True, False):
        c = dict(cfg, fp_include_coulomb=on)
        ref = _reference(c, "on")
        init = ref.state
        for s in seeds:
            ref.state = init._replace(key=jax.random.PRNGKey(s))
            port = pex.small_corona(**c, seed=s, device="cpu")
            for label, sim in (("reference", ref), ("port", port)):
                for i in range(steps):
                    out = sim.step()
                    tea = _np(sim.state.zones.tea)
                    print(f"coulomb {'on' if on else 'off'} {label} seed {s} "
                          f"step {i}: balance "
                          f"{sim.energy_audit()['balance']:.6f} Te mean "
                          f"{tea.mean():.2f} keV, by z row "
                          f"{' '.join(f'{t:.1f}' for t in tea.mean(1))}; FP "
                          f"substeps {int(_np(out.fp_substeps))}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", choices=("te", "trajectory", "fp",
                                     "precision", "deck", "coulomb"))
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--step", type=int, default=3)
    ap.add_argument("--size", choices=tuple(SIZES), default="mid")
    ap.add_argument("--deck", choices=("disk_deck", "ec_deck"),
                    default="ec_deck")
    ap.add_argument("--slots", type=int, default=8192)
    ap.add_argument("--nst", type=int, default=4000)
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    if args.what == "te":
        te(args.seeds, args.steps)
    elif args.what == "trajectory":
        trajectory(args.seeds, args.steps)
    elif args.what == "precision":
        precision(args.steps)
    elif args.what == "deck":
        deck(args.deck, args.seeds, args.steps, args.slots, args.nst)
    elif args.what == "coulomb":
        coulomb(args.seeds, args.steps, args.slots, args.nst)
    else:
        fp(args.step, args.size)


if __name__ == "__main__":
    main()
