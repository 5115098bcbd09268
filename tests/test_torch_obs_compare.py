"""The port's Mrk 421 observation check (``compton2d_tpu_torch.obs_compare``)
against the committed ``artifacts/mrk421_dense`` comparison and against
the reference tool (``tools/obs_compare.py``) on the same points."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from compton2d_tpu_torch import obs_compare as oc

REPO = Path(__file__).resolve().parent.parent
ART = REPO / "artifacts" / "mrk421_dense"
SED = str(ART / "sed.dat")
COUNTS = {"xray_flare_2001 (x_newa1)": 35, "xray_low_2001 (rxte)": 34,
          "xray_veryhigh_2001 (rxte)": 34, "xray_low_1998 (sax)": 56,
          "xray_high_1998 (sax)": 56, "tev_2001 (g_newa1)": 5}
SUMMARY = ("model_sync_peak_keV_obs", "model_ssc_peak_keV_obs",
           "sync_peak_in_obs_decade", "xray_log10_model_over_obs_median",
           "global_renorm_log10", "tev_log10_residual_after_renorm",
           "n_tev_model_records")


def _close(a, b, rtol=1e-5):
    """Equal, or both numbers within rtol (NaN matching NaN), elementwise
    through lists and dicts."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _close(a[k], b[k], rtol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, rtol)
    elif isinstance(a, (bool, str)) or a is None:
        assert a == b
    else:
        np.testing.assert_allclose(a, b, rtol=rtol, equal_nan=True)


def test_overlay_holds_every_dataset():
    obs = oc.load_obs_overlay()
    assert {k: len(v[0]) for k, v in obs.items()} == COUNTS
    for e, f, err in obs.values():
        assert np.all(e > 0) and np.all(f > 0) and err is None


def test_compare_reproduces_the_committed_summary(tmp_path):
    """compare() on the committed sed.dat with the committed overlay's
    points gives the committed obs_compare.json's numbers to rtol 1e-5
    (the overlay prints 7 digits) and writes its overlay table again, byte
    for byte."""
    s = oc.compare(SED, oc.load_obs_overlay(), str(tmp_path))
    ref = json.loads((ART / "obs_compare.json").read_text())
    assert set(s) == set(ref)
    for k in SUMMARY:
        _close(s[k], ref[k])
    _close(s["per_dataset"], ref["per_dataset"])
    assert s["sync_peak_in_obs_decade"]
    assert ((tmp_path / "obs_compare.dat").read_bytes()
            == (ART / "obs_compare.dat").read_bytes())
    assert json.loads((tmp_path / "obs_compare.json").read_text()) == \
        json.loads(json.dumps(s))


def _write_reference_files(obs, d: Path):
    """The overlay's points in the reference's observation files (log10 nu
    [Hz], log10 nuFnu; error columns of zero), as tools/obs_compare.py
    reads them."""
    h = 4.135667e-18

    def lg(x):
        return np.log10(x)

    def write(name, cols):
        np.savetxt(d / name, np.stack(cols, axis=1), fmt="%.17g")

    e, f, _ = obs["xray_flare_2001 (x_newa1)"]
    z = np.zeros_like(e)
    write("x_newa1.dat", [lg(e / h), lg(f), z, z])
    e, lo, _ = obs["xray_low_2001 (rxte)"]
    _, hi, _ = obs["xray_veryhigh_2001 (rxte)"]
    write("rxte_01_low_and_high.dat", [lg(e / h), lg(lo), lg(hi),
                                       np.zeros_like(e)])
    e, lo, _ = obs["xray_low_1998 (sax)"]
    _, hi, _ = obs["xray_high_1998 (sax)"]
    write("sax_98_and_00.dat", [lg(e / h), lg(lo), lg(hi), np.zeros_like(e)])
    e, f, _ = obs["tev_2001 (g_newa1)"]
    write("g_newa1.dat", [lg(e / h), lg(f), 0.1 * f])


def test_compare_matches_the_reference_tool(tmp_path):
    """The reference tool's compare on observation files holding the
    overlay's points and the port's compare on the overlay: the same
    summary."""
    spec = importlib.util.spec_from_file_location(
        "obs_compare_tool", REPO / "tools" / "obs_compare.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    obs = oc.load_obs_overlay()
    d = tmp_path / "obs"
    d.mkdir()
    _write_reference_files(obs, d)
    (tmp_path / "ref").mkdir()
    want = tool.compare(SED, str(d), str(tmp_path / "ref"))
    got = oc.compare(SED, obs)
    for k in SUMMARY:
        _close(got[k], want[k], rtol=1e-9)
    _close(got["per_dataset"], want["per_dataset"], rtol=1e-9)


def test_sed_without_earth_column_raises(tmp_path):
    p = tmp_path / "sed.dat"
    np.savetxt(p, np.ones((5, 3)))
    with pytest.raises(ValueError, match="nuFnu_earth"):
        oc.compare(str(p), oc.load_obs_overlay())
