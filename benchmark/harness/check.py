"""The comparison that decides ``correct``.

The plain reference (``reference/c2dref``, a frozen copy of the port's
plain step; ``reference/postprocess.py``) follows the program step by
step: from the program's own state before each replayed step of the
window's last repetition, with its random stream at that point, it works
out the step again, with its own tables, grid, scales and sources built
from the configuration, and the numbers below compare the two. The start
(the program's initial zones against the reference's, built from the
configuration alone) counts in the same numbers.

- ``step_rel``: the largest relative gap, over the replayed steps, of
  what a step leaves: each zone's electron temperature and electron
  distribution (the zone pass, tracking and the FP solve; a distribution
  as the sum of the absolute gaps over the sum of the reference's), the
  step's tallies (deposit, census, radiation field, escaping spectrum and
  light curves, boundary leaks, each as that sum; the net scattering gain
  and killed energy against the step's input energy), the photons
  tracked, the escaping records' count and energy, the census it leaves
  (count, energy), its clock and cycle, and in a run to t_stop the step's
  records as the event file holds them (each column). One number for
  all: under the control the zones of the corona move by less than their
  rounding (TF32 reaches the FP solve only through its inverse-Compton
  contraction), and the Mrk 421 blob's temperatures sit at their floor,
  so only the whole separates the two readings in every cell; each part
  is printed on the ``# detail`` line;
- ``free_rel``: the same gaps of the zones, the census and the clock
  between the program's state after its first steps from t = 0 (a
  segment cell's set-up steps, or the first ``free_steps`` of the
  window's last run) and the reference's after as many steps run on its
  own from its own initial state and random stream: nothing of the
  program enters it, so a fault that builds up over steps, or one in
  the state the program prepares, shows;
- ``outputs_rel`` (to_tstop): the largest such gap of a column of the
  program's ``sed.dat`` or ``lc.dat`` against the reference's binning of
  the same event file (one number for both: the files hold 7 digits, so
  the light curves alone read their rounding, as float32 does);
- ``ranks_diff`` (several ranks): the largest absolute gap of the zones
  (temperatures and distributions) between a rank and rank 0 after the
  window, which the exchange keeps at 0.

The control (``control=True``) puts the reference, run with TF32 on (and
its post-processing in float32), in the program's place.
"""
from __future__ import annotations

import contextlib
import os
import sys
from pathlib import Path

import numpy as np
import torch

REF_DIR = Path(__file__).resolve().parent.parent / "reference"
if str(REF_DIR) not in sys.path:
    sys.path.insert(0, str(REF_DIR))


def _gap(p: torch.Tensor, r: torch.Tensor) -> float:
    """sum |p - r| / sum |r| in float64 (0 when both are 0)."""
    p, r = p.double(), r.double()
    num = float(torch.sum(torch.abs(p - r)))
    den = float(torch.sum(torch.abs(r)))
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


def _zone_gaps(p_zones, r_zones):
    te = float(torch.max(torch.abs(p_zones.tea.double() - r_zones.tea.double())
                         / r_zones.tea.double()))
    fp = p_zones.f_nt.double().reshape(-1, p_zones.f_nt.shape[-1])
    fr = r_zones.f_nt.double().reshape(-1, fp.shape[-1])
    fnt = float(torch.max(torch.sum(torch.abs(fp - fr), -1)
                          / torch.clamp_min(torch.sum(torch.abs(fr), -1),
                                            1e-300)))
    return te, fnt


TALLY_FIELDS = ("edep", "ecens", "n_field", "fout", "edout", "erlk_inner",
                "erlk_outer", "erlk_upper", "erlk_lower")
# net sums of many gains and losses: their gap is taken against the
# step's input energy, not against themselves
NET_FIELDS = ("e_killed", "e_scatter")


def _events(ev):
    n = int(ev.count.sum())
    cap = ev.data.shape[0]
    return torch.tensor([float(min(n, cap))]), \
        ev.data[:min(n, cap), 2].double().sum().reshape(1).cpu()


def _tally_gaps(po, ro) -> dict:
    gaps = {f: _gap(getattr(po.tallies, f), getattr(ro.tallies, f))
            for f in TALLY_FIELDS}
    scale = float(torch.abs(ro.bingo.double()))
    for f in NET_FIELDS:
        d = float(torch.abs(getattr(po.tallies, f).double()
                            - getattr(ro.tallies, f).double()))
        gaps[f] = d / scale if scale > 0 else (0.0 if d == 0 else np.inf)
    gaps["n_tracked"] = _gap(po.n_tracked, ro.n_tracked)
    (pn, pe), (rn, re) = _events(po.events), _events(ro.events)
    gaps["records"] = _gap(pn, rn)
    gaps["records_energy"] = _gap(pe, re)
    return gaps


def _records(out, ref) -> np.ndarray:
    """A step's escaping records as the event file writes them (weights
    in erg)."""
    n = min(int(out.events.count.sum()), out.events.data.shape[0])
    rec = out.events.data[:n].double().cpu().numpy()
    rec[:, 2] *= ref.scales.E
    return rec


def _file_rows(cell, cap) -> list:
    """The event file of the last run, cut into each step's records by the
    steps' counts."""
    ev = np.loadtxt(os.path.join(cell.out_dir, "evb.dat")).reshape(-1, 7)
    counts = [min(int(o.events.count.sum()), o.events.data.shape[0])
              for _, _, o in cap.steps]
    ends = np.cumsum(counts)
    if ends[-1] != ev.shape[0]:
        return [np.zeros((0, 7))] * len(counts)
    return np.split(ev, ends[:-1])


def _records_gap(p: np.ndarray, r: np.ndarray) -> float:
    if p.shape != r.shape:
        return float("inf")
    return max([0.0] + [_gap(torch.from_numpy(p[:, j]),
                             torch.from_numpy(r[:, j]))
                        for j in range(r.shape[1])])


def _state_gaps(ps, rs) -> dict:
    def census(s):
        a = s.photons.alive
        return torch.stack([a.sum().double(),
                            torch.where(a, s.photons.w, 0.0).double().sum(),
                            s.time.double(), s.ncycle.double()]).cpu()
    p, r = census(ps), census(rs)
    return {k: _gap(p[i:i + 1], r[i:i + 1]) for i, k in enumerate(
        ("census_count", "census_energy", "time", "ncycle"))}


def to_reference(state, gen_state, device):
    """The program's state as the reference's SimState: each tuple field
    by name, tensors copied, and a generator of the reference's own at the
    program's point of the random stream."""
    from c2dref import state as rs

    def conv(cls, x):
        return cls(**{f: getattr(x, f).clone() for f in cls._fields})

    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    return rs.SimState(
        zones=conv(rs.ZoneState, state.zones),
        photons=conv(rs.PhotonArray, state.photons),
        key=gen, **{f: getattr(state, f).clone() for f in rs.SimState._fields
                    if f not in ("zones", "photons", "key")})


@contextlib.contextmanager
def _tf32(on: bool):
    """TF32 in matrix products and convolutions as ``on`` says, for the
    length of the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _replay(ref, capture, device, i: int, tf32: bool):
    """The reference's step from the pre-step state of step ``i``, with
    TF32 as ``tf32`` says: (state after, outputs)."""
    with _tf32(tf32):
        pre, g, _ = capture.steps[i]
        st = to_reference(pre, g, device)
        return ref.step(st, float(st.time), float(st.dt), int(st.ncycle))


def _after(capture, i):
    return (capture.steps[i + 1][0] if i + 1 < len(capture.steps)
            else capture.final)


def picks_of(n_steps: int, k: int, seed: int) -> list:
    """``k`` of the ``n_steps`` steps, drawn from ``seed``, the last one
    always among them."""
    if k >= n_steps:
        return list(range(n_steps))
    rng = np.random.default_rng(seed)
    rest = rng.choice(n_steps - 1, size=k - 1, replace=False)
    return sorted(int(x) for x in rest) + [n_steps - 1]


def step_numbers(cell, control: bool = False) -> dict:
    """step_rel of the program (or, with ``control``, of the reference
    under TF32) against the reference; its parts go to ``cell.detail``."""
    ref = _reference(cell)
    cap = cell.last
    picks = picks_of(len(cap.steps), cell.w["check_steps"], cell.seed)
    te, fnt = _zone_gaps(cell.initial.zones, ref.zones0)
    detail = {}
    rows = _file_rows(cell, cap) if cell.w["kind"] == "to_tstop" else None
    for i in picks:
        new, out = _replay(ref, cap, cell.device, i, False)
        if control:
            p_state, p_out = _replay(ref, cap, cell.device, i, True)
        else:
            p_state, p_out = _after(cap, i), cap.steps[i][2]
        a, b = _zone_gaps(p_state.zones, new.zones)
        te, fnt = max(te, a), max(fnt, b)
        gaps = {**_tally_gaps(p_out, out), **_state_gaps(p_state, new)}
        if rows is not None:
            gaps["event_file"] = _records_gap(
                rows[i] if not control else _records(p_out, ref),
                _records(out, ref))
        for k, v in gaps.items():
            detail[k] = max(detail.get(k, 0.0), v)
        del new, out, p_state, p_out
    cell.detail = dict(detail, te=te, f_nt=fnt)
    return {"step_rel": max(cell.detail.values())}


def _reference(cell):
    """The reference of the cell's deployment (built once a run), with a
    mesh of its own on several ranks."""
    if getattr(cell, "reference", None) is None:
        from c2dref.config import ZoneInit
        from c2dref.step import Reference

        mesh = None
        if cell.mesh is not None:
            from c2dref.parallel.mesh import PhotonMesh
            mesh = PhotonMesh(rank=cell.mesh.rank, world=cell.mesh.world,
                              backend=cell.mesh.backend, device=cell.device)
        zi = ZoneInit(**vars(cell.zone_init))
        cell.reference = Reference(_ref_config(cell.cfg), zi, cell.device,
                                   mesh)
    return cell.reference


def initial_state(ref, n_slots: int, seed: int):
    """The reference's own state at t = 0 (the program's
    ``Simulation.__init__``, frozen): its initial zones, an empty census
    of this rank's slots, and the random stream of ``seed`` on this
    rank."""
    from c2dref import state as rs
    from c2dref.parallel.mesh import rank_seed

    dev, g = ref.device, ref.cfg.grid
    rank, world = (0, 1) if ref.mesh is None else (ref.mesh.rank,
                                                  ref.mesh.world)
    gen = torch.Generator(device=dev)
    gen.manual_seed(rank_seed(int(seed), rank))

    def zf(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    def scal(v, dtype=torch.float32):
        return torch.tensor(v, dtype=dtype, device=dev)

    return rs.SimState(
        zones=rs.ZoneState(*[t.clone() for t in ref.zones0]),
        photons=rs.PhotonArray.empty(n_slots // world, dev),
        time=scal(0.0), dt=scal(ref.dt0), dt_prev=scal(ref.dt0),
        ncycle=scal(0, torch.int32), key=gen,
        ed_abs=zf(g.nr), ed_ref=zf(g.nr),
        k_gg=zf(g.nz, g.nr, g.n_gg), dn_pp=zf(g.nz, g.nr, g.num_nt),
        dne_pa=zf(g.nz, g.nr, g.num_nt), dnp_pa=zf(g.nz, g.nr, g.num_nt))


def _free_run(ref, n_slots: int, seed: int, n_steps: int, tf32: bool):
    """The reference's state after ``n_steps`` steps from its own t = 0
    on the random stream of ``seed``, with TF32 as ``tf32`` says."""
    with _tf32(tf32):
        st = initial_state(ref, n_slots, seed)
        time_, dt = 0.0, float(st.dt)
        for ncycle in range(n_steps):
            st, _ = ref.step(st, time_, dt, ncycle)
            time_ += dt
            if ref.cfg.run.adaptive_dt:
                dt = float(st.dt)
        return st


def free_numbers(cell, control: bool = False) -> dict:
    """free_rel: the program's state after its first steps from t = 0
    (a segment cell's set-up steps; the first ``free_steps`` of the
    window's last run) against the reference's after as many steps run
    on its own from its own initial state and the same random stream,
    which takes nothing from the program (with ``control``, the
    reference under TF32 in the program's place). Its parts go to
    ``cell.detail`` with the prefix ``free_``."""
    ref = _reference(cell)
    w = cell.w
    if w["kind"] == "segment":
        n, stream, prog = w["setup_steps"], w["streams"][0], cell.snapshot
    else:
        n = w["free_steps"]
        stream = w["streams"][cell.order[-1]]
        prog = _after(cell.last, n - 1)
    new = _free_run(ref, cell.cfg.run.n_slots, stream, n, False)
    if control:
        prog = _free_run(ref, cell.cfg.run.n_slots, stream, n, True)
    te, fnt = _zone_gaps(prog.zones, new.zones)
    gaps = dict(_state_gaps(prog, new), te=te, f_nt=fnt)
    cell.detail.update({f"free_{k}": v for k, v in gaps.items()})
    return {"free_rel": max(gaps.values())}


def _ref_config(cfg):
    """The program's SimConfig as the reference's (every field by name)."""
    import dataclasses
    from c2dref import config as rc

    def conv(x):
        if dataclasses.is_dataclass(x):
            cls = getattr(rc, type(x).__name__)
            return cls(**{f.name: conv(getattr(x, f.name))
                          for f in dataclasses.fields(x)})
        if isinstance(x, tuple):
            return tuple(conv(v) for v in x)
        return x
    return conv(cfg)


def output_numbers(cell, control: bool = False) -> dict:
    """outputs_rel of the program's last run (with ``control``, of the
    reference's binning in float32) against the reference's binning in
    float64 of the same event file."""
    import postprocess as rp

    ev = np.loadtxt(os.path.join(cell.out_dir, "evb.dat")).reshape(-1, 7)
    pp = cell.c["postprocess"]
    r_max = cell.c["grid"]["r_max"]
    ref = rp.sed_and_lc(ev, r_max, pp)
    if control:
        prog = rp.sed_and_lc(ev, r_max, pp, np.float32)
    else:
        prog = tuple(np.loadtxt(os.path.join(cell.out_dir, f))
                     for f in ("sed.dat", "lc.dat"))
    gap = 0.0
    for p, r in zip(prog, ref):
        if p.shape != r.shape:
            return {"outputs_rel": float("inf")}
        gap = max([gap] + [_gap(torch.from_numpy(np.asarray(p[:, j], float)),
                                torch.from_numpy(np.asarray(r[:, j], float)))
                           for j in range(1, r.shape[1])])
    return {"outputs_rel": gap}


def ranks_number(cell) -> dict:
    """ranks_diff: the largest gap of a rank's zones from rank 0's."""
    import torch.distributed as dist

    z = cell.sim.state.zones
    mine = torch.cat([z.tea.reshape(-1), z.f_nt.reshape(-1)]).float()
    root = mine.clone()
    dist.broadcast(root, src=0)
    gap = torch.max(torch.abs(mine - root)).reshape(1)
    dist.all_reduce(gap, op=dist.ReduceOp.MAX)
    return {"ranks_diff": float(gap)}


def numbers(cell, control: bool = False) -> dict:
    """Every number the cell compares."""
    out = {}
    if cell.mesh is not None and not control:
        out.update(ranks_number(cell))
    out.update(step_numbers(cell, control))
    out.update(free_numbers(cell, control))
    if cell.w["kind"] == "to_tstop":
        out.update(output_numbers(cell, control))
    return out


def verdict(nums: dict, limits: dict) -> bool:
    """Every number at or below its limit (a NaN fails)."""
    return all(k in limits and np.isfinite(v) and v <= limits[k]
               for k, v in nums.items())
