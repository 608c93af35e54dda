"""The curve-fitting slice as a whole: the port's ``CurveFitter``,
``PolyFitter``, ``curve_fit`` and ``polyfit`` against ``dosma_tpu``'s.

Both packages get the same numpy inputs (``numpy.random.RandomState``) and,
for the fitters, ``MedicalVolume``s built from the same arrays and affine.
``dosma_tpu`` is driven through its device routes (the monoexponential,
biexponential and generic Pallas kernels) in Pallas interpret mode, by
patching their ``pallas_supported`` to True as ``tests/ops/test_biexp_pallas.py``
does. The port fits CPU data with the plain versions of its kernels. The
cases mirror ``tests/core/test_fitting.py``.

Tolerances:
  - parameters |Δp| ≤ 1e-4 · max(1, |p|) and r² within 1e-4 on noiseless
    data; 2e-3 · max(1, |p|) on the 2% noise case. The JAX kernels keep
    polishing a latched voxel until their block has latched; the port
    freezes each voxel at its latch (see the ops tests for the bounds).
  - biexponential fits: fitted curves within 1e-4 (the parameters of a
    biexponential are ill-conditioned; curves are not).
  - scipy routes (untraceable models, scipy-only keywords): identical bits,
    since both packages hand scipy the same float arrays.
  - NaN and fill positions, shapes, affines and headers identical.
"""

import math
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import dosma_tpu
import dosma_tpu_torch as dt
from dosma_tpu.core import fitting as jfit
from dosma_tpu.ops import biexp_pallas, generic_lm_pallas, monoexp_pallas
from dosma_tpu_torch.ops import biexp as tbiexp
from dosma_tpu_torch.ops import generic_lm as tgeneric
from dosma_tpu_torch.ops import monoexp as tmonoexp
from dosma_tpu_torch.ops import nlls as tnlls


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU."""
    from dosma_tpu_torch.core.device import default_device

    with default_device("cpu"):
        yield


_X4 = np.array([10.0, 20.0, 30.0, 40.0], np.float32)
_X8 = np.linspace(0.0, 10.0, 8).astype(np.float32)
_P0M = (1.0, -1 / 30)
_P0B = (1.0, -0.5, 0.4, -0.04)


@pytest.fixture
def jax_device_routes(monkeypatch):
    """Send dosma_tpu's curve_fit through its Pallas kernels (interpret mode)."""
    for mod in (monoexp_pallas, biexp_pallas, generic_lm_pallas):
        monkeypatch.setattr(mod, "pallas_supported", lambda: True)
    with pltpu.force_tpu_interpret_mode():
        yield


def _mono_Y(N=64, seed=0, noise=0.0):
    rs = np.random.RandomState(seed)
    b = -1 / (rs.rand(N) * 70 + 10)
    Y = np.exp(b[None, :] * _X4[:, None])
    if noise:
        Y = Y * (1 + noise * rs.randn(*Y.shape))
    return Y.astype(np.float32), b  # (T, N)


def _bi_Y(N=64, seed=0):
    rs = np.random.RandomState(seed)
    a1, b1 = 0.8 + 0.4 * rs.rand(N), -(0.4 + 0.2 * rs.rand(N))
    a2, b2 = 0.3 + 0.3 * rs.rand(N), -(0.03 + 0.03 * rs.rand(N))
    x = _X8[:, None]
    return (a1 * np.exp(b1 * x) + a2 * np.exp(b2 * x)).astype(np.float32)


def _assert_fit_close(out_t, out_j, ptol=1e-4):
    (pt, rt), (pj, rj) = out_t, out_j
    assert isinstance(pt, np.ndarray) and isinstance(rt, np.ndarray)
    pj, rj = np.asarray(pj), np.asarray(rj)
    assert pt.shape == pj.shape and rt.shape == rj.shape
    np.testing.assert_array_equal(np.isnan(pt), np.isnan(pj))
    fin = np.isfinite(pj)
    assert (np.abs(pt - pj)[fin] <= ptol * np.maximum(1.0, np.abs(pj[fin]))).all()
    np.testing.assert_allclose(rt, rj, rtol=0, atol=1e-4)


def _biexp_curve(p, x=_X8):
    return p[:, 0:1] * np.exp(p[:, 1:2] * x) + p[:, 2:3] * np.exp(p[:, 3:4] * x)


def _np_only_monoexp(x, a, b):
    """Module-level (hence picklable) model that neither jax nor
    ``torch.func.jvp`` can trace: both packages take the scipy loop."""
    return a * np.frompyfunc(math.exp, 1, 1)(b * x).astype(np.float64)


def _offset_j(x, a, b, c):
    return a * jnp.exp(b * x) + c


def _offset_t(x, a, b, c):
    return a * torch.exp(b * x) + c


class _Spy:
    """Counts calls to one of the port's engines, then runs it."""

    def __init__(self, monkeypatch, module, name):
        self.calls = 0
        real = getattr(module, name)

        def spy(*args, **kwargs):
            self.calls += 1
            return real(*args, **kwargs)

        monkeypatch.setattr(module, name, spy)


# ----------------------------------------------------------------------
# curve_fit
# ----------------------------------------------------------------------
class TestCurveFit:
    @pytest.mark.parametrize("noise", [0.0, 0.02], ids=["clean", "noisy"])
    def test_monoexponential_matches_jax(self, jax_device_routes, monkeypatch, noise):
        Y, b = _mono_Y(noise=noise)
        spy = _Spy(monkeypatch, tmonoexp, "monoexp_lm")
        out_t = dt.curve_fit(dt.monoexponential, _X4, Y, p0=_P0M, maxfev=200)
        out_j = dosma_tpu.curve_fit(jfit.monoexponential, _X4, Y, p0=_P0M, maxfev=200)
        assert spy.calls == 1
        _assert_fit_close(out_t, out_j, 1e-4 if noise == 0 else 2e-3)
        if noise == 0:
            np.testing.assert_allclose(out_t[0][:, 1], b, atol=1e-4)

    def test_all_zero_and_y_bounds(self, jax_device_routes):
        Y, _ = _mono_Y(N=32)
        Y[:, 5] = 0
        Y[0, 3] = 100.0
        with pytest.warns(UserWarning, match="Out of bounds"):
            out_t = dt.curve_fit(dt.monoexponential, _X4, Y, y_bounds=(0, 10), p0=_P0M)
        with pytest.warns(UserWarning, match="Out of bounds"):
            out_j = dosma_tpu.curve_fit(jfit.monoexponential, _X4, Y, y_bounds=(0, 10), p0=_P0M)
        _assert_fit_close(out_t, out_j)
        for i in (3, 5):
            assert np.isnan(out_t[0][i]).all() and out_t[1][i] == 0

    def test_biexponential_matches_jax(self, jax_device_routes, monkeypatch):
        Y = _bi_Y()
        spy = _Spy(monkeypatch, tbiexp, "biexp_lm")
        pt, rt = dt.curve_fit(dt.biexponential, _X8, Y, p0=_P0B, maxfev=100)
        pj, rj = dosma_tpu.curve_fit(jfit.biexponential, _X8, Y, p0=_P0B, maxfev=100)
        assert spy.calls == 1
        np.testing.assert_array_equal(np.isnan(pt), np.isnan(np.asarray(pj)))
        ok = np.isfinite(pt).all(1)
        assert ok.mean() > 0.95
        np.testing.assert_allclose(_biexp_curve(pt[ok]), _biexp_curve(np.asarray(pj)[ok]),
                                   atol=1e-4)
        np.testing.assert_allclose(_biexp_curve(pt[ok]), Y.T[ok], atol=1e-3)

    def test_user_model_takes_generic_kernel(self, jax_device_routes, monkeypatch):
        rs = np.random.RandomState(4)
        x = np.array([5.0, 15.0, 30.0, 50.0, 80.0], np.float32)
        a, b, c = rs.rand(48) + 0.5, -1 / (rs.rand(48) * 70 + 10), rs.rand(48) * 0.2
        Y = (a * np.exp(b * x[:, None]) + c).astype(np.float32)
        spy = _Spy(monkeypatch, tgeneric, "generic_lm")
        lm = _Spy(monkeypatch, tnlls, "lm_fit")
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # an accepted model routes silently
            out_t = dt.curve_fit(_offset_t, x, Y, p0=(1.0, -1 / 30, 0.0), maxfev=60)
        out_j = dosma_tpu.curve_fit(_offset_j, x, Y, p0=(1.0, -1 / 30, 0.0), maxfev=60)
        assert spy.calls == 1 and lm.calls == 0
        _assert_fit_close(out_t, out_j)

    def test_refused_model_takes_lm_fit_with_warning(self, monkeypatch):
        Y, b = _mono_Y(N=32, seed=5)

        def clamped(x, a, bb):
            return torch.clamp(a, min=0.0) * torch.exp(bb * x)

        def clamped_j(x, a, bb):
            return jnp.clip(a, 0.0) * jnp.exp(bb * x)

        spy = _Spy(monkeypatch, tgeneric, "generic_lm")
        lm = _Spy(monkeypatch, tnlls, "lm_fit")
        with pytest.warns(UserWarning, match=r"clamp.*lm_fit on cpu"):
            out_t = dt.curve_fit(clamped, _X4, Y, p0=_P0M)
        assert spy.calls == 0 and lm.calls == 1
        out_j = dosma_tpu.curve_fit(clamped_j, _X4, Y, p0=_P0M)  # JAX's own lm_fit
        _assert_fit_close(out_t, out_j)
        np.testing.assert_allclose(out_t[0][:, 1], b, atol=1e-4)

    def test_more_than_four_params_take_lm_fit(self, monkeypatch):
        Y, _ = _mono_Y(N=16, seed=6)

        def five(x, a, b, c, d, e):
            return a * torch.exp(b * x) + c * d * e

        lm = _Spy(monkeypatch, tnlls, "lm_fit")
        with pytest.warns(UserWarning, match="P = 5"):
            popt, r2 = dt.curve_fit(five, _X4, Y, p0=(1.0, -1 / 30, 0.0, 1.0, 1.0), maxfev=20)
        assert lm.calls == 1 and popt.shape == (16, 5)

    def test_untraceable_model_takes_scipy_like_jax(self):
        Y, b = _mono_Y(N=9, seed=7)
        with pytest.warns(UserWarning, match="not differentiable by torch.func.jvp"):
            out_t = dt.curve_fit(_np_only_monoexp, _X4, Y, p0=_P0M)
        with pytest.warns(UserWarning, match="not jax-traceable"):
            out_j = dosma_tpu.curve_fit(_np_only_monoexp, _X4, Y, p0=_P0M)
        np.testing.assert_array_equal(out_t[0], out_j[0])
        np.testing.assert_array_equal(out_t[1], out_j[1])
        np.testing.assert_allclose(out_t[0][:, 1], b, atol=1e-3)

    def test_scipy_workers_equal_serial(self):
        Y, b = _mono_Y(N=8, seed=8)
        with pytest.warns(UserWarning, match="not differentiable"):
            p_ser, r_ser = dt.curve_fit(_np_only_monoexp, _X4, Y, p0=_P0M)
        with pytest.warns(UserWarning, match="not differentiable"):
            p_par, r_par = dt.curve_fit(_np_only_monoexp, _X4, Y, p0=_P0M, num_workers=2)
        assert np.array_equal(p_ser, p_par, equal_nan=True) and np.array_equal(r_ser, r_par)

    def test_scipy_workers_unpicklable_use_threads(self):
        Y, b = _mono_Y(N=6, seed=9)

        def closure_model(x, a, bb):
            return a * np.vectorize(math.exp)(bb * x)

        with pytest.warns(UserWarning, match="threads"):
            p_par, _ = dt.curve_fit(closure_model, _X4, Y, p0=_P0M, num_workers=2)
        np.testing.assert_allclose(p_par[:, 1], b, atol=1e-3)

    def test_scipy_only_kwargs_route_to_scipy_like_jax(self):
        Y, _ = _mono_Y(N=9, seed=10)
        sigma = np.ones_like(_X4)
        with pytest.warns(UserWarning, match="scipy engine"):
            out_t = dt.curve_fit(dt.monoexponential, _X4, Y, p0=_P0M, sigma=sigma)
        with pytest.warns(UserWarning, match="scipy engine"):
            out_j = dosma_tpu.curve_fit(jfit.monoexponential, _X4, Y, p0=_P0M, sigma=sigma)
        np.testing.assert_array_equal(out_t[0], out_j[0])
        np.testing.assert_array_equal(out_t[1], out_j[1])

    def test_unhashable_callable_model(self):
        class Model:
            __hash__ = None

            def __eq__(self, other):
                return self is other

            def __call__(self, x, a, b):
                return a * torch.exp(b * x)

        Y, b = _mono_Y(N=9, seed=11)
        popt, _ = dt.curve_fit(Model(), _X4, Y, p0=_P0M)
        np.testing.assert_allclose(popt[:, 1], b, atol=1e-3)

    @pytest.mark.parametrize("kernel", ["auto", "pallas_monoexp", "generic"])
    def test_kernel_hints_match_jax(self, jax_device_routes, monkeypatch, kernel):
        Y, _ = _mono_Y(N=48, seed=12)

        def my_monoexp(xx, a, bb):  # a user function with the library's parametrization
            return a * torch.exp(bb * xx)

        def my_monoexp_j(xx, a, bb):
            return a * jnp.exp(bb * xx)

        spies = {name: _Spy(monkeypatch, mod, name) for mod, name in (
            (tmonoexp, "monoexp_lm"), (tgeneric, "generic_lm"), (tnlls, "lm_fit"))}
        out_t = dt.curve_fit(my_monoexp, _X4, Y, p0=_P0M, kernel=kernel)
        out_j = dosma_tpu.curve_fit(my_monoexp_j, _X4, Y, p0=_P0M, kernel=kernel)
        expected = "monoexp_lm" if kernel == "pallas_monoexp" else "generic_lm"
        assert {k: s.calls for k, s in spies.items()} == {
            "monoexp_lm": int(expected == "monoexp_lm"),
            "generic_lm": int(expected == "generic_lm"),
            "lm_fit": 0,
        }
        _assert_fit_close(out_t, out_j)

    def test_biexp_hint_and_generic_hint_on_library_biexp(self, jax_device_routes, monkeypatch):
        Y = _bi_Y(N=32, seed=13)

        def my_biexp(x, a1, b1, a2, b2):
            return a1 * torch.exp(b1 * x) + a2 * torch.exp(b2 * x)

        bi = _Spy(monkeypatch, tbiexp, "biexp_lm")
        gen = _Spy(monkeypatch, tgeneric, "generic_lm")
        p_hint, _ = dt.curve_fit(my_biexp, _X8, Y, p0=_P0B, kernel="pallas_biexp")
        p_gen, _ = dt.curve_fit(dt.biexponential, _X8, Y, p0=_P0B, kernel="generic")
        assert bi.calls == 1 and gen.calls == 1
        for p in (p_hint, p_gen):
            ok = np.isfinite(p).all(1)
            assert ok.mean() > 0.9
            np.testing.assert_allclose(_biexp_curve(p[ok]), Y.T[ok], atol=1e-3)

    def test_unknown_kernel_raises(self):
        with pytest.raises(ValueError, match="kernel"):
            dt.curve_fit(dt.monoexponential, [1.0, 2.0], np.ones((2, 4)), kernel="bogus")

    def test_tensor_in_tensor_out(self):
        Y, _ = _mono_Y(N=16, seed=14)
        popt, r2 = dt.curve_fit(dt.monoexponential, torch.from_numpy(_X4),
                                torch.from_numpy(Y), p0=_P0M)
        assert isinstance(popt, torch.Tensor) and popt.shape == (16, 2)
        assert isinstance(r2, torch.Tensor) and r2.device.type == "cpu"
        p_np, _ = dt.curve_fit(dt.monoexponential, _X4, Y, p0=_P0M)
        np.testing.assert_array_equal(popt.numpy(), p_np)

    def test_one_dimensional_y_and_dict_p0(self, jax_device_routes):
        Y, _ = _mono_Y(N=1, seed=15)
        p0 = {"a": 1.0, "b": -1 / 30}
        out_t = dt.curve_fit(dt.monoexponential, _X4, Y[:, 0], p0=p0)
        out_j = dosma_tpu.curve_fit(jfit.monoexponential, _X4, Y[:, 0], p0=p0)
        assert out_t[0].shape == (1, 2)
        _assert_fit_close(out_t, out_j)


# ----------------------------------------------------------------------
# polyfit
# ----------------------------------------------------------------------
class TestPolyfit:
    @pytest.mark.parametrize("deg", [1, 2])
    def test_matches_jax_and_numpy(self, deg):
        rs = np.random.RandomState(deg)
        x = np.linspace(0, 5, 6)
        Y = rs.rand(6, 100)
        pt, rt = dt.polyfit(x, Y, deg)
        pj, rj = dosma_tpu.polyfit(x, Y, deg)
        assert isinstance(pt, np.ndarray) and pt.shape == (100, deg + 1)
        np.testing.assert_allclose(pt, np.asarray(pj), atol=1e-4)
        np.testing.assert_allclose(rt, np.asarray(rj), atol=1e-4)
        np.testing.assert_allclose(pt.T, np.polyfit(x, Y, deg), atol=1e-4)

    def test_all_zero_and_oob_sequences_nan(self):
        rs = np.random.RandomState(1)
        x = np.linspace(1, 4, 4)
        Y = rs.rand(4, 10) + 0.1
        Y[:, 2] = 0.0
        Y[0, 7] = 50.0
        pt, rt = dt.polyfit(x, Y, 1)
        assert np.isnan(pt[2]).all() and rt[2] == 0 and np.isfinite(np.delete(pt, 2, 0)).all()
        with pytest.warns(UserWarning):
            pt_w, rt_w = dt.polyfit(x, Y, 1, w=np.ones_like(x), y_bounds=(0.0, 10.0))
        with pytest.warns(UserWarning):
            pj_w, rj_w = dosma_tpu.polyfit(x, Y, 1, w=np.ones_like(x), y_bounds=(0.0, 10.0))
        for i in (2, 7):
            assert np.isnan(pt_w[i]).all() and rt_w[i] == 0
        np.testing.assert_array_equal(pt_w, pj_w)
        np.testing.assert_array_equal(rt_w, rj_w)

    def test_full_and_cov_match_jax(self):
        rs = np.random.RandomState(2)
        x = np.linspace(0, 3, 7)
        Y = rs.rand(7, 12)
        full_t = dt.polyfit(x, Y, 2, full=True)
        full_j = dosma_tpu.polyfit(x, Y, 2, full=True)
        assert len(full_t) == len(full_j) == 6
        for u, v in zip(full_t, full_j):
            np.testing.assert_allclose(np.asarray(u), np.asarray(v), rtol=1e-12)
        cov_t = dt.polyfit(x, Y[:, :1], 2, cov=True)
        cov_j = dosma_tpu.polyfit(x, Y[:, :1], 2, cov=True)
        for u, v in zip(cov_t, cov_j):
            np.testing.assert_allclose(np.asarray(u), np.asarray(v), rtol=1e-12)

    def test_tensor_in_tensor_out(self):
        x = np.arange(5, dtype=np.float32)
        Y = torch.from_numpy((2 * x + 1).reshape(-1, 1))
        popt, r2 = dt.polyfit(x, Y, 1)
        assert isinstance(popt, torch.Tensor) and popt.shape == (1, 2)
        torch.testing.assert_close(popt[0], torch.tensor([2.0, 1.0]), atol=1e-5, rtol=0)
        assert float(r2[0]) > 0.99999


# ----------------------------------------------------------------------
# CurveFitter / PolyFitter over MedicalVolumes
# ----------------------------------------------------------------------
_SHAPE = (6, 6, 2)


def _volumes(seed=0, headers=False):
    rs = np.random.RandomState(seed)
    b = -1 / (rs.rand(*_SHAPE) * 70 + 10)
    arrays = [np.exp(b * t).astype(np.float32) for t in _X4]
    arrays[0][0, 0, 0] = arrays[1][0, 0, 0] = arrays[2][0, 0, 0] = arrays[3][0, 0, 0] = 0
    affine = dosma_tpu.to_affine(dosma_tpu.SAGITTAL, spacing=(0.5, 0.5, 2.0), origin=(1, 2, 3))
    hdr = None
    if headers:
        hdr = [np.array([{"EchoTime": float(t)}], dtype=object) for t in _X4]
    ys_j = [dosma_tpu.MedicalVolume(a, affine, headers=None if hdr is None else hdr[i])
            for i, a in enumerate(arrays)]
    ys_t = [dt.MedicalVolume(a, affine, headers=None if hdr is None else hdr[i])
            for i, a in enumerate(arrays)]
    return ys_j, ys_t, b


def _assert_maps_close(vt, vj, atol=1e-4):
    assert isinstance(vt.A, np.ndarray)
    assert vt.shape == vj.shape and vt.orientation == vj.orientation
    np.testing.assert_array_equal(vt.affine, vj.affine)
    at, aj = vt.A, np.asarray(vj.A)
    np.testing.assert_array_equal(np.isnan(at), np.isnan(aj))
    fin = np.isfinite(aj)
    np.testing.assert_allclose(at[fin], aj[fin], rtol=0, atol=atol)


_FITTER_CASES = {
    "defaults_r2_none": dict(p0=_P0M, r2_threshold=None),
    "r2_preferences": dict(p0=_P0M),
    "r2_number_nan_to_num": dict(p0=_P0M, r2_threshold=0.999, nan_to_num=0.0),
    "p0_scalar": dict(p0=-0.03, r2_threshold=None, maxfev=200),
    "p0_dict": dict(p0={"a": 1.0, "b": -1 / 30}, r2_threshold=None),
    "out_ufuncs_and_bounds": dict(
        p0=_P0M, out_ufuncs=[None, lambda v: 1 / abs(v)],
        out_bounds=((-np.inf, np.inf), (0, 50)), r2_threshold=None),
    "one_ufunc_one_bound": dict(p0=_P0M, out_ufuncs=lambda v: v * 2, out_bounds=(-1.0, 1.0)),
    "y_bounds": dict(p0=_P0M, y_bounds=(0.0, 0.9), r2_threshold=None),
}


@pytest.mark.parametrize("with_mask", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("name", list(_FITTER_CASES))
def test_curve_fitter_matches_jax(jax_device_routes, name, with_mask):
    kwargs = dict(_FITTER_CASES[name])
    ys_j, ys_t, _ = _volumes(seed=len(name))
    mask = None
    if with_mask:
        mask = np.zeros(_SHAPE)
        mask[1:4] = 1
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # y_bounds warns in both
        pj, rj = dosma_tpu.CurveFitter(jfit.monoexponential, **kwargs).fit(_X4, ys_j, mask=mask)
        pt, rt = dt.CurveFitter(dt.monoexponential, **kwargs).fit(_X4, ys_t, mask=mask)
    _assert_maps_close(pt, pj)
    _assert_maps_close(rt, rj)
    assert pt.shape == _SHAPE + (2,)
    if with_mask:
        fill = kwargs.get("nan_to_num")
        outside = pt.A[mask == 0]
        assert (np.isnan(outside) if fill is None else outside == fill).all()


def test_curve_fitter_per_voxel_p0(jax_device_routes):
    ys_j, ys_t, b = _volumes(seed=3)
    b0 = np.full(_SHAPE, -1 / 30)
    for p0 in ({"a": 1.0, "b": b0}, {"a": 1.0, "b": dt.MedicalVolume(b0, ys_t[0].affine)},
               np.stack([np.ones(_SHAPE), b0], axis=-1)):
        p0_j = p0
        if isinstance(p0, dict) and isinstance(p0["b"], dt.MedicalVolume):
            p0_j = {"a": 1.0, "b": dosma_tpu.MedicalVolume(b0, ys_j[0].affine)}
        fitter_t = dt.CurveFitter(dt.monoexponential, r2_threshold=None)
        fitter_j = dosma_tpu.CurveFitter(jfit.monoexponential, r2_threshold=None)
        pt, _ = fitter_t.fit(_X4, ys_t, p0=p0)
        pj, _ = fitter_j.fit(_X4, ys_j, p0=p0_j)
        _assert_maps_close(pt, pj)
        np.testing.assert_allclose(pt.A[1:, ..., 1], b[1:], atol=1e-4)


def test_curve_fitter_masked_per_voxel_p0(jax_device_routes):
    ys_j, ys_t, b = _volumes(seed=4)
    mask = np.zeros(_SHAPE)
    mask[2:4] = 1
    p0 = {"a": 1.0, "b": np.full(_SHAPE, -1 / 25)}
    pt, _ = dt.CurveFitter(dt.monoexponential, r2_threshold=None).fit(_X4, ys_t, mask=mask, p0=p0)
    pj, _ = dosma_tpu.CurveFitter(jfit.monoexponential, r2_threshold=None).fit(
        _X4, ys_j, mask=mask, p0=p0)
    _assert_maps_close(pt, pj)
    np.testing.assert_allclose(pt.A[2:4, ..., 1], b[2:4], atol=1e-4)


def test_curve_fitter_headers(jax_device_routes):
    ys_j, ys_t, _ = _volumes(seed=5, headers=True)
    pt, rt = dt.CurveFitter(dt.monoexponential, p0=_P0M, r2_threshold=None).fit(_X4, ys_t)
    pj, rj = dosma_tpu.CurveFitter(jfit.monoexponential, p0=_P0M, r2_threshold=None).fit(
        _X4, ys_j)
    assert pt.headers().shape == pj.headers().shape and rt.headers().shape == rj.headers().shape
    assert pt.headers().flat[0]["EchoTime"] == pj.headers().flat[0]["EchoTime"]
    assert pt.headers().flat[0] is not ys_t[0].headers().flat[0]  # a copy
    pn, rn = dt.CurveFitter(dt.monoexponential, p0=_P0M).fit(_X4, ys_t, copy_headers=False)
    assert pn.headers() is None and rn.headers() is None


def test_curve_fitter_biexponential_matches_jax(jax_device_routes):
    rs = np.random.RandomState(6)
    shape = (4, 4, 2)
    a1, b1 = 0.8 + 0.4 * rs.rand(*shape), -(0.4 + 0.2 * rs.rand(*shape))
    a2, b2 = 0.3 + 0.3 * rs.rand(*shape), -(0.03 + 0.03 * rs.rand(*shape))
    arrays = [(a1 * np.exp(b1 * t) + a2 * np.exp(b2 * t)).astype(np.float32) for t in _X8]
    ys_t = [dt.MedicalVolume(a, np.eye(4)) for a in arrays]
    ys_j = [dosma_tpu.MedicalVolume(a, np.eye(4)) for a in arrays]
    pt, rt = dt.CurveFitter(dt.biexponential, p0=_P0B, r2_threshold=None).fit(_X8, ys_t)
    pj, rj = dosma_tpu.CurveFitter(jfit.biexponential, p0=_P0B, r2_threshold=None).fit(_X8, ys_j)
    ct = _biexp_curve(pt.A.reshape(-1, 4))
    cj = _biexp_curve(np.asarray(pj.A).reshape(-1, 4))
    np.testing.assert_allclose(ct, cj, atol=1e-4)
    np.testing.assert_allclose(rt.A, np.asarray(rj.A), atol=1e-5)


def test_tensor_volumes_give_tensor_maps_and_tensor_ufuncs():
    _, ys_np, b = _volumes(seed=7)
    ys = [dt.MedicalVolume(torch.from_numpy(v.A), v.affine) for v in ys_np]
    seen = []

    def to_tc(v):
        seen.append(type(v))
        return 1 / abs(v)

    fitter = dt.CurveFitter(dt.monoexponential, p0=_P0M, out_ufuncs=[None, to_tc],
                            r2_threshold=None)
    pt, rt = fitter.fit(_X4, ys, mask=np.ones(_SHAPE))
    assert isinstance(pt.A, torch.Tensor) and isinstance(rt.A, torch.Tensor)
    assert seen == [torch.Tensor]
    p_np, _ = fitter.fit(_X4, ys_np, mask=np.ones(_SHAPE))
    assert seen == [torch.Tensor, np.ndarray]  # numpy-backed volumes: numpy, as in dosma_tpu
    np.testing.assert_allclose(pt.A.numpy(), p_np.A, rtol=1e-6, equal_nan=True)
    np.testing.assert_allclose(pt.A.numpy()[1:, ..., 1], 1 / np.abs(b[1:]), rtol=1e-4)


def test_curve_fitter_validation_and_str():
    with pytest.raises(TypeError):
        dt.CurveFitter(dt.monoexponential, out_ufuncs=[1, 2])
    with pytest.raises(ValueError):
        dt.CurveFitter(dt.monoexponential, out_bounds=(1, 0))
    with pytest.raises(ValueError):
        dt.CurveFitter(dt.monoexponential, r2_threshold="sometimes")
    with pytest.warns(UserWarning, match="Extra ufuncs"):
        dt.CurveFitter(dt.monoexponential, out_ufuncs=[None, None, None])
    _, ys, _ = _volumes()
    with pytest.raises(TypeError):
        dt.CurveFitter(dt.monoexponential).fit(_X4, [1, 2, 3, 4])
    with pytest.raises(ValueError):
        dt.CurveFitter(dt.monoexponential).fit(_X4[:3], ys)
    s_t = str(dt.CurveFitter(dt.monoexponential, p0=_P0M))
    s_j = str(dosma_tpu.CurveFitter(jfit.monoexponential, p0=_P0M))
    assert s_t == s_j


@pytest.mark.parametrize("deg", [1, 2])
def test_poly_fitter_matches_jax(deg):
    ys_j, ys_t, b = _volumes(seed=8)
    logs_t = [dt.MedicalVolume(np.log(np.maximum(v.A, 1e-6)), v.affine) for v in ys_t]
    logs_j = [dosma_tpu.MedicalVolume(np.log(np.maximum(np.asarray(v.A), 1e-6)), v.affine)
              for v in ys_j]
    mask = np.ones(_SHAPE)
    mask[0] = 0
    pt, rt = dt.PolyFitter(deg=deg, r2_threshold=None).fit(_X4, logs_t, mask=mask)
    pj, rj = dosma_tpu.PolyFitter(deg=deg, r2_threshold=None).fit(_X4, logs_j, mask=mask)
    _assert_maps_close(pt, pj, atol=1e-4)
    _assert_maps_close(rt, rj, atol=1e-4)
    if deg == 1:
        np.testing.assert_allclose(pt.A[1:, ..., 0], b[1:], atol=1e-5)
    assert str(dt.PolyFitter(deg=deg)) == str(dosma_tpu.PolyFitter(deg=deg))
