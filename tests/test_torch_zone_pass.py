"""The zone pass of the port (B field, volume emission, Compton opacity,
electron distributions) against the JAX reference on the same inputs,
rtol 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compton2d_tpu import config as jcfg
from compton2d_tpu import tables as jtables
from compton2d_tpu import units as junits
from compton2d_tpu.physics import compton as jcompton
from compton2d_tpu.physics import electron_dist as jed
from compton2d_tpu.physics import emissivity as jem
from compton2d_tpu_torch import config as pcfg
from compton2d_tpu_torch import tables as ptables
from compton2d_tpu_torch import units as punits
from compton2d_tpu_torch.physics import compton as pcompton
from compton2d_tpu_torch.physics import electron_dist as ped
from compton2d_tpu_torch.physics import emissivity as pem

torch.set_num_threads(2)

GRID = dict(nz=3, nr=2, num_nt=50, n_vol=64, nphfield=64, n_gg=32,
            n_ref=100, nmu=4)
L = 1.0e15
RTOL = 1e-5


@pytest.fixture(scope="module")
def tabs():
    return (ptables.build_tables(pcfg.GridConfig(**GRID), L),
            jtables.build_tables(jcfg.GridConfig(**GRID), L))


def _zones(seed=0):
    rng = np.random.default_rng(seed)
    sh = (3, 2)
    return dict(
        tea=rng.uniform(5.0, 300.0, sh), tna=rng.uniform(5.0, 300.0, sh),
        n_e=10.0 ** rng.uniform(8, 11, sh), B=rng.uniform(1.0, 300.0, sh),
        amxwl=rng.uniform(0.2, 1.0, sh), gmin=rng.uniform(5.0, 50.0, sh),
        gmax=rng.uniform(1e3, 1e5, sh), p_nth=rng.uniform(2.0, 3.0, sh),
        f_pair=rng.uniform(0.0, 0.1, sh),
    )


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a)).to(dtype)


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _close(a, b, rtol=RTOL, name=""):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=rtol,
                               atol=rtol * 1e-3 * np.abs(b).max() + 1e-37,
                               err_msg=name)


def test_init_f_nt_and_build_cdf(tabs):
    tp, tj = tabs
    z = _zones()
    args = [z[k] for k in ("tea", "amxwl", "gmin", "gmax", "p_nth")]
    fp = ped.init_f_nt(tp.gnt, *map(_t, args))
    fj = jed.init_f_nt(tj.gnt, *map(_j, args))
    _close(fp, fj, name="f_nt")
    _close(ped.build_cdf(fp, tp.gnt), jed.build_cdf(fj, tj.gnt), name="cdf")


def test_gamma_bar_table(tabs):
    tp, tj = tabs
    th = np.geomspace(1e-5, 40.0, 200).astype(np.float32)
    _close(tp.gamma_bar.forward(_t(th)), tj.gamma_bar.forward(_j(th)))
    gb = np.linspace(1.0, 100.0, 200).astype(np.float32)
    _close(tp.gamma_bar.inverse(_t(gb)), tj.gamma_bar.inverse(_j(gb)))


def test_equipartition_b(tabs):
    tp, tj = tabs
    z = _zones(1)
    ep = np.array([[0, 1], [2, 1], [2, 0]], np.int32)
    names = ("tea", "tna", "n_e", "f_pair", "B")
    bp = pem.equipartition_b(_t(ep, torch.int32), *(_t(z[k]) for k in names),
                             tp.gamma_bar.forward)
    bj = jem.equipartition_b(jnp.asarray(ep), *(_j(z[k]) for k in names),
                             tj.gamma_bar.forward)
    _close(bp, bj)


def test_zone_sigma_table(tabs):
    tp, tj = tabs
    z = _zones(2)
    args = [z[k] for k in ("tea", "amxwl", "gmin", "gmax", "p_nth")]
    fj = jed.init_f_nt(tj.gnt, *map(_j, args))
    sp = pcompton.zone_sigma_table(tp.sigma_e, _t(fj), tp.gnt, _t(z["n_e"]))
    sj = jcompton.zone_sigma_table(tj.sigma_e, fj, tj.gnt, _j(z["n_e"]))
    _close(sp, sj)


def test_volume_em(tabs):
    tp, tj = tabs
    z = _zones(3)
    args = [z[k] for k in ("tea", "amxwl", "gmin", "gmax", "p_nth")]
    fj = jed.init_f_nt(tj.gnt, *map(_j, args))
    rng = np.random.default_rng(4)
    vol = rng.uniform(0.01, 0.1, (3, 2))
    surf = rng.uniform(0.1, 1.0, (3, 2))
    lmin = np.full((3, 2), 0.3)
    dt = 3.3e3
    sp = punits.make_scales(1e15, 1e15, 1e50)
    sj = junits.make_scales(1e15, 1e15, 1e50)
    names = ("tea", "n_e", "B", "amxwl")
    vp = pem.volume_em(tp.e_ph, tp.gnt, _t(fj), *(_t(z[k]) for k in names),
                       _t(vol), _t(surf), _t(lmin), torch.tensor(dt), sp,
                       f_pair=_t(z["f_pair"]))
    vj = jem.volume_em(tj.e_ph, tj.gnt, fj, *(_j(z[k]) for k in names),
                       _j(vol), _j(surf), _j(lmin), jnp.float32(dt),
                       tj.sync, sj, f_pair=_j(z["f_pair"]))
    for name in vj._fields:
        _close(getattr(vp, name), getattr(vj, name), name=name)
