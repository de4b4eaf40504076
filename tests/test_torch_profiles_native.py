"""The port's native profile-CSV reader (``io.profiles_native``) against the
JAX package's and against pandas: the five cases of
tests/test_profiles_native.py, each read by both packages (the same library,
so every output is equal bit for bit) and held to the pandas oracle there."""

import warnings

import numpy as np
import pandas as pd
import pytest

from lesionvae_tpu.io import profiles_native as jpn
from lesionvae_tpu_torch.io import profiles_native as tpn

pytestmark = pytest.mark.skipif(not tpn.available(),
                                reason="native CSV parser cannot be built here")


def _both(path, columns):
    """Both packages' readers on one file: equal outputs, returned once."""
    got = tpn.read_profile_columns(path, columns)
    want = jpn.read_profile_columns(path, columns)
    assert got is not None and want is not None
    vals, starts, names, present = got
    assert vals.dtype == np.float32 and vals.shape == want[0].shape
    np.testing.assert_array_equal(vals.view(np.uint32), want[0].view(np.uint32))
    np.testing.assert_array_equal(starts, want[1])
    assert names == want[2]
    np.testing.assert_array_equal(present, want[3])
    return got


def test_matches_pandas(tmp_path):
    rng = np.random.default_rng(0)
    n = 50
    df = pd.DataFrame({
        "tract_id": ["a"] * 20 + ["b"] * 25 + ["a"] * 5,  # a reappears
        "streamline_id": np.arange(n),
        "f1": rng.normal(size=n).astype(np.float32),
        "f2": rng.normal(size=n).astype(np.float32) * 1e-7,
        "f3": rng.normal(size=n).astype(np.float32) * 1e6,
    })
    df.loc[3, "f1"] = np.nan
    df.loc[4, "f2"] = np.inf
    df.loc[5, "f3"] = -np.inf
    fp = tmp_path / "p.csv"
    df.to_csv(fp, index=False)

    vals, starts, names, present = _both(fp, ["f1", "f2", "f3", "absent_col"])
    assert present.tolist() == [True, True, True, False]
    assert np.isnan(vals[:, 3]).all()
    for j, c in enumerate(["f1", "f2", "f3"]):
        np.testing.assert_allclose(vals[:, j], df[c].to_numpy(np.float32), rtol=1e-6,
                                   atol=1e-30, equal_nan=True, err_msg=c)
    np.testing.assert_array_equal(starts, [0, 20, 45])
    assert names == ["a", "b", "a"]


def test_crlf_and_no_trailing_newline(tmp_path):
    fp = tmp_path / "p.csv"
    fp.write_bytes(b"tract_id,f1\r\nx,1.5\r\ny,-2.25e1")
    vals, starts, names, _ = _both(fp, ["f1"])
    np.testing.assert_allclose(vals[:, 0], [1.5, -22.5])
    assert names == ["x", "y"]


def test_short_rows_and_junk_fields(tmp_path):
    fp = tmp_path / "p.csv"
    fp.write_text("tract_id,f1,f2\na,1.0,2.0\na,3.0\nb,notanum,4.0\n")
    vals, starts, names, _ = _both(fp, ["f1", "f2"])
    np.testing.assert_allclose(vals[0], [1.0, 2.0])
    assert vals[1, 0] == 3.0 and np.isnan(vals[1, 1])
    assert np.isnan(vals[2, 0]) and vals[2, 1] == 4.0


@pytest.mark.parametrize("content,columns", [("", ["f1"]), ("a,b\n1,2\n", ["a"])])
def test_malformed_inputs(tmp_path, content, columns):
    fp = tmp_path / "bad.csv"
    fp.write_text(content)
    with pytest.raises(ValueError) as got:
        tpn.read_profile_columns(fp, columns)
    with pytest.raises(ValueError) as want:
        jpn.read_profile_columns(fp, columns)
    assert str(got.value) == str(want.value)


def test_parse_float_bit_exact_vs_pandas(tmp_path):
    """Bit-exact against pandas' float64 parse cast to float32, on random
    values at every scale, short and full prints and the edge tokens."""
    rng = np.random.default_rng(7)
    vals = rng.standard_normal(3000) * 10.0 ** rng.integers(-35, 35, 3000)
    strs = [repr(float(v)) for v in vals]
    strs += ["%.6g" % v for v in vals[:500]]
    strs += ["%.17g" % v for v in vals[500:1000]]
    strs += [".5", "-.25", "5.", "+3.25", "1e999", "-1e999", "00012.5",
             "1.00000000000000000001", "9007199254740993", "1e-45",
             "3.4028235e38", "3.4028236e38", "1.1754944e-38", "2.5e-324",
             "123456789012345678901234567890", "0.1", "0.2", "0.3",
             "inf", "-inf", "nan", ""]
    fp = tmp_path / "exact.csv"
    fp.write_text("tract_id,x\n" + "".join(f"t,{s}\n" for s in strs))
    native = _both(fp, ["x"])[0][:, 0]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # overflow on cast
        ref = pd.read_csv(fp, skip_blank_lines=False)["x"].to_numpy(
            np.float64).astype(np.float32)
    assert len(native) == len(ref)
    eq = (native == ref) | (np.isnan(native) & np.isnan(ref))
    bad = np.where(~eq)[0]
    assert eq.all(), [(strs[i], native[i], ref[i]) for i in bad[:5]]


def test_unavailable_reader_returns_none(monkeypatch, tmp_path):
    """Where the library cannot be built the reader says so and returns
    None; the caller reads with pandas."""
    monkeypatch.setattr(tpn, "_load", lambda: None)
    fp = tmp_path / "p.csv"
    fp.write_text("tract_id,f1\na,1.0\n")
    assert not tpn.available()
    assert tpn.read_profile_columns(fp, ["f1"]) is None
