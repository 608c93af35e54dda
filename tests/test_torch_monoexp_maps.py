"""The fit's finished maps in one call (``ops/monoexp.py::monoexp_maps``).

On a card the kernel's maps entry (``csrc/monoexp_lm.cu::dosma_monoexp_maps``)
fits the echoes and applies the epilogue in registers; ``tests/
test_torch_cuda.py`` and ``chip_smoke.py`` phase 4 hold it bit for bit to
the plain version below and to the unfused composition on the card. Here, on
the CPU:

  - the plain version (``monoexp_maps`` on CPU tensors: ``_packed_reference``,
    the NaN policy and ``maps_epilogue``) equals, bit for bit, the
    composition the pipeline ran before the maps entry existed:
    ``monoexp_lm_reference`` followed by the torch post-processing, written
    out below as it was;
  - it agrees with the JAX package's ``monoexp_fit_full`` (Pallas in
    interpret mode) to ``test_torch_fitting.py``'s tolerances, away from
    voxels whose time constant or r² lies within those tolerances of a
    bound or of the threshold;
  - the launcher hands the kernel the rows where they lie (a stand-in for
    the library records the call);
  - ``MonoExponentialFit.fit`` gives the same maps for host and tensor
    volumes, and counts ``fit.echoes_in_place`` only where a card's kernel
    read the rows.
"""

import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

import dosma_tpu_torch as dt
from dosma_tpu_torch.ops import monoexp as mx
from dosma_tpu_torch.ops.monoexp import (
    maps_epilogue, monoexp_lm_reference, monoexp_maps, monoexp_maps_reference,
)
from dosma_tpu_torch.ops.monoexp_pipeline import monoexp_fit_full
from dosma_tpu_torch.utils.profiling import counters


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU."""
    from dosma_tpu_torch.core.device import default_device

    with default_device("cpu"):
        yield


def _times(T, uniform):
    if uniform:
        return (10.0 * np.arange(1, T + 1)).astype(np.float32)
    return np.sort(np.random.RandomState(T).rand(T) * 60 + 3).astype(np.float32)


def _echoes(T, uniform, N=360, seed=0, sigma=0.01):
    """(x (T,), yT (T, N)): noisy decays with the edge voxels up front: all
    zero, constant, growing, negated, one zero echo, and time constants
    far below and above the fitted range."""
    rs = np.random.RandomState(seed)
    x = _times(T, uniform)
    b = -1 / (rs.rand(N) * 90 + 5)
    yT = np.exp(b[None] * x[:, None]) + sigma * rs.randn(T, N)
    yT[:, 0] = 0
    yT[:, 1] = 0.7
    yT[:, 2] = np.exp(0.02 * x)
    yT[:, 3] = -yT[:, 3]
    yT[T // 2, 4] = 0
    yT[:, 5:9] = np.exp(-x[:, None] / np.array([0.5, 2.0, 400.0, 5e4])[None])
    return x, yT.astype(np.float32)


def _mask(kind, N, seed=1):
    if kind is None:
        return None
    m = np.random.RandomState(seed).randint(-2, 3, N)
    m[:20] = 1  # the edge voxels inside
    if kind == "bool":
        return torch.from_numpy(m > 0)
    return torch.from_numpy(m.astype(kind))


def _composition(x, yT, bounds, tc0, r2_threshold, decimals, mask, nan_fill, max_iter=100):
    """The pipeline's maps before the maps entry: ``monoexp_lm_reference``
    and then its torch post-processing, as they were written."""
    p0 = None if tc0 == "polyfit" else torch.tensor([1.0, -1.0 / float(tc0)], dtype=torch.float32)
    popt, r2, _ = monoexp_lm_reference(x, yT, p0, max_iter=max_iter, y_layout="tn",
                                       uniform_x=mx._detect_uniform_x(x))
    lb, ub = bounds
    tc = 1.0 / torch.abs(popt[:, 1])
    tc = torch.where((tc < lb) | (tc > ub), torch.nan, tc)
    if r2_threshold is not None:
        tc = torch.where(r2 < r2_threshold, torch.nan, tc)
    if mask is not None:
        inside = torch.as_tensor(mask).to(torch.float32).reshape(-1) > 0
        tc = torch.where(inside, tc, torch.nan)
        r2 = torch.where(inside, r2, nan_fill)
    tc = torch.nan_to_num(tc, nan=nan_fill)
    if decimals is not None:
        tc = torch.round(tc, decimals=int(decimals))
    return tc, r2


def _bits_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


_BASE = dict(T=4, uniform=True, tc0="polyfit", r2_threshold=0.9, decimals=1, mask="uint8",
             nan_fill=0.0, bounds="data", max_iter=100)
_CASES = {
    "T3_uniform": dict(T=3),
    "T3_nonuniform": dict(T=3, uniform=False),
    "T4_uniform": dict(),
    "T4_nonuniform": dict(uniform=False),
    "T9_uniform": dict(T=9),
    "T9_nonuniform": dict(T=9, uniform=False),
    "decimals_none": dict(decimals=None),
    "decimals_0": dict(decimals=0),
    "decimals_3": dict(decimals=3),
    "decimals_minus_1": dict(decimals=-1),
    "r2_threshold_none": dict(r2_threshold=None),
    "mask_none": dict(mask=None),
    "mask_int32": dict(mask="int32"),
    "mask_float32": dict(mask="float32"),
    "mask_bool": dict(mask="bool"),
    "nan_fill_negative": dict(nan_fill=-2.5),
    "nan_fill_nan": dict(nan_fill=float("nan")),
    "tc0_number": dict(tc0=30.0),
    "tc0_number_T9": dict(tc0=25.0, T=9, uniform=False, decimals=3),
    "unconverged": dict(max_iter=2, r2_threshold=None),
    "bounds_wide": dict(bounds=(0, 100)),
    # A rate seed of -0 leaves the constant voxel at b = -0: tc = +inf
    # inside infinite bounds, then the float32 maximum.
    "tc_inf": dict(tc0=float("inf"), bounds=(0.0, float("inf")), r2_threshold=None,
                   decimals=None, nan_fill=3.0),
    "tc_inf_rounded": dict(tc0=float("inf"), bounds=(-float("inf"), float("inf")),
                           r2_threshold=None, decimals=1),
}


def _inputs(name):
    c = {**_BASE, **_CASES[name]}
    x, yT = _echoes(c["T"], c["uniform"])
    mask = _mask(c["mask"], yT.shape[1])
    bounds = c["bounds"]
    if bounds == "data":
        # Bounds at two fitted time constants: voxels lie at, below and
        # above each bound.
        tc, _ = _composition(x, yT, (0.0, float("inf")), c["tc0"], None, None, None, 0.0,
                             c["max_iter"])
        kept = np.sort(tc.numpy()[tc.numpy() > 0])
        bounds = (float(kept[len(kept) // 5]), float(kept[4 * len(kept) // 5]))
    return c, x, yT, mask, bounds


@pytest.mark.parametrize("name", list(_CASES))
def test_plain_maps_equal_the_unfused_composition(name):
    c, x, yT, mask, bounds = _inputs(name)
    want = _composition(x, torch.from_numpy(yT), bounds, c["tc0"], c["r2_threshold"],
                        c["decimals"], mask, c["nan_fill"], c["max_iter"])
    p0 = None if c["tc0"] == "polyfit" else np.array([1.0, -1.0 / c["tc0"]], np.float32)
    launches = counters["monoexp_lm.launches"]
    got = monoexp_maps(x, torch.from_numpy(yT), p0, max_iter=c["max_iter"], bounds=bounds,
                       r2_threshold=c["r2_threshold"], decimals=c["decimals"], mask=mask,
                       nan_fill=c["nan_fill"])
    assert counters["monoexp_lm.launches"] == launches  # CPU data never reaches the kernel
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (yT.shape[1],)
        assert _bits_equal(g, w)
    tc = got[0]
    if name == "tc_inf":
        assert float(tc[1]) == np.finfo(np.float32).max  # the constant voxel
    if name == "tc_inf_rounded":
        assert float(tc[1]) == float("inf")  # the float32 maximum rounds past it
    # The pipeline, from the stacked echoes and from the rows, gives the same bits.
    for y in (torch.from_numpy(yT), [torch.from_numpy(r) for r in yT]):
        full = monoexp_fit_full(x, y, bounds, c["tc0"], c["r2_threshold"], c["decimals"],
                                mask_flat=None if mask is None else mask.to(torch.float32),
                                nan_fill=c["nan_fill"], max_iter=c["max_iter"])
        assert all(_bits_equal(f, w) for f, w in zip(full, want))


def test_every_bound_is_met_at_below_and_above():
    _, x, yT, _, (lb, ub) = _inputs("decimals_none")
    tc, _ = _composition(x, yT, (0.0, float("inf")), "polyfit", None, None, None, 0.0)
    for bound in (lb, ub):
        assert (tc == bound).any() and (tc < bound).any() and (tc > bound).any()


_JAX_CASES = ["T3_uniform", "T4_nonuniform", "T9_uniform", "decimals_none", "decimals_3",
              "decimals_minus_1", "r2_threshold_none", "mask_int32", "mask_bool",
              "nan_fill_negative", "tc0_number", "bounds_wide"]


@pytest.mark.parametrize("name", _JAX_CASES)
def test_maps_match_the_jax_pipeline(name):
    from dosma_tpu.ops.monoexp_pipeline import monoexp_fit_full as jax_fit_full

    c, x, yT, mask, bounds = _inputs(name)
    args = dict(bounds=bounds, tc0=c["tc0"], r2_threshold=c["r2_threshold"],
                decimal_precision=c["decimals"], nan_fill=c["nan_fill"],
                max_iter=c["max_iter"])
    mask_np = None if mask is None else mask.numpy()
    with pltpu.force_tpu_interpret_mode():
        tc_j, r2_j = jax_fit_full(x, yT, mask_flat=mask_np, **args)
    tc_j, r2_j = np.asarray(tc_j), np.asarray(r2_j)
    tc_t, r2_t = (v.numpy() for v in monoexp_fit_full(
        x, [torch.from_numpy(r) for r in yT],
        mask_flat=None if mask is None else mask.to(torch.float32), **args))

    # Voxels within the fits' agreement of a bound or of the threshold may
    # fall on either side of it.
    raw, r2_raw = _composition(x, yT, (-np.inf, np.inf), c["tc0"], None, None, None, 0.0)
    raw, r2_raw = raw.numpy().astype(np.float64), r2_raw.numpy()
    near = np.zeros(raw.shape, bool)
    for bound in bounds:
        if np.isfinite(bound):
            near |= np.abs(raw - bound) <= 1e-4 * max(1.0, abs(bound))
    if c["r2_threshold"] is not None:
        near |= np.abs(r2_raw - c["r2_threshold"]) <= 1e-4
    assert near.mean() < 0.02
    # The edge voxels 2-8 (growing, negated, a zero echo, time constants far
    # outside the echoes) are ill-conditioned: the two fits may stop apart.
    near[2:9] = True
    keep = ~near
    fill = c["nan_fill"]
    np.testing.assert_array_equal(tc_t[keep] == fill, tc_j[keep] == fill)
    d = c["decimals"]
    # The fits agree to 1e-4 relative; rounded, a value may also move by the
    # rounding step.
    tol = 1e-4 * np.maximum(np.abs(tc_j[keep]), 1.0) + (0.0 if d is None else 10.0 ** -d)
    assert np.all(np.abs(tc_t[keep] - tc_j[keep]) <= tol)
    np.testing.assert_allclose(r2_t[keep], r2_j[keep], rtol=0, atol=1e-4)
    assert (tc_t != fill).mean() > 0.2  # the case keeps real voxels


@pytest.mark.parametrize("b", [0.0, -0.0, float("inf"), -float("inf"), float("nan"), -1 / 30])
@pytest.mark.parametrize("decimals", [None, 1, -1])
def test_epilogue_of_extreme_rates(b, decimals):
    rates = torch.tensor([b, -1 / 45, 1 / 45], dtype=torch.float32)
    r2 = torch.tensor([0.95, 0.5, 0.99], dtype=torch.float32)
    mask = torch.tensor([1.0, 1.0, -1.0])
    got = maps_epilogue(rates, r2, (-float("inf"), float("inf")), 0.9, decimals, mask, -7.0)
    tc = 1.0 / torch.abs(rates)
    tc = torch.where(r2 < 0.9, torch.nan, tc)
    tc = torch.where(mask > 0, tc, torch.nan)
    want_r2 = torch.where(mask > 0, r2, -7.0)
    tc = torch.nan_to_num(tc, nan=-7.0)
    if decimals is not None:
        tc = torch.round(tc, decimals=decimals)
    assert _bits_equal(got[0], tc) and _bits_equal(got[1], want_r2)
    if b == 0.0 and decimals is None:
        assert float(got[0][0]) == np.finfo(np.float32).max


def test_reference_entry_point_equals_cpu_dispatch():
    x, yT = _echoes(4, True, N=200, seed=3)
    mask = _mask("int32", 200)
    kw = dict(bounds=(5.0, 80.0), r2_threshold=0.9, decimals=2, mask=mask, nan_fill=-1.0)
    for a, b in zip(monoexp_maps(x, torch.from_numpy(yT), **kw),
                    monoexp_maps_reference(x, [torch.from_numpy(r) for r in yT], **kw)):
        assert _bits_equal(a, b)


def test_maps_reject_wrong_shapes():
    x, yT = _echoes(4, True, N=16)
    with pytest.raises(ValueError):
        monoexp_maps(x[:3], torch.from_numpy(yT))
    with pytest.raises(ValueError):
        monoexp_maps(x, [torch.from_numpy(r) for r in yT[:3]])
    with pytest.raises(ValueError):
        monoexp_maps(x, torch.from_numpy(yT), mask=np.ones(15, np.uint8))


class _Library:
    """A stand-in for the kernel library's ``dosma_monoexp_maps``: records
    each call's arguments and reports success."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def library(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(mx, "_maps_kernel_fn", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=None))
    return lib


def _launch(y, decimals=1, r2_threshold=0.9, mask=None, T=4):
    x = torch.from_numpy(_times(T, True))
    return mx._maps_kernel(x, y, None, 100, 1e-5, 1e-5, True,
                           ((0, 100), r2_threshold, decimals, mask, 0.0))


def _pointers(arg):
    return [ctypes.cast(arg, ctypes.POINTER(ctypes.c_void_p))[i] for i in range(len(arg))]


def test_the_kernel_reads_the_rows_where_they_lie(library):
    _, yT = _echoes(4, True, N=50)
    rows = [torch.from_numpy(r) for r in yT]
    before = dict(counters)
    tc, r2 = _launch(rows)
    (args,) = library.calls
    assert _pointers(args[1]) == [r.data_ptr() for r in rows]
    assert args[2:4] == (0, 1)  # y_st (unused), y_sn
    assert args[9:11] == (50, 4)  # N, T
    assert args[7:9] == (tc.data_ptr(), r2.data_ptr())
    assert counters["fit.echoes_in_place"] == before.get("fit.echoes_in_place", 0) + 1
    assert counters["monoexp_lm.launches"] == before.get("monoexp_lm.launches", 0) + 1


def test_a_stacked_buffer_is_read_by_rows_or_as_one_buffer(library):
    for T in (4, 9):
        _, yT = _echoes(T, True, N=50)
        y = torch.from_numpy(yT)
        before = counters["fit.echoes_in_place"]
        _launch(y, T=T)
        args = library.calls[-1]
        want = [y[t].data_ptr() for t in range(T)] if T <= mx.ROW_ECHOES else [y.data_ptr()]
        assert _pointers(args[1]) == want
        assert args[2:4] == (50, 1)
        assert counters["fit.echoes_in_place"] == before


@pytest.mark.parametrize("decimals,mode,scale", [(None, 0, 1.0), (0, 1, 1.0), (1, 1, 10.0),
                                                 (3, 1, 1000.0), (-1, -1, 10.0)])
@pytest.mark.parametrize("r2_threshold", [None, 0.9])
def test_the_epilogue_reaches_the_kernel(library, decimals, mode, scale, r2_threshold):
    _, yT = _echoes(4, True, N=30)
    mask = torch.ones(30)
    _launch(torch.from_numpy(yT), decimals, r2_threshold, mask)
    args = library.calls[-1]
    assert args[6] == mask.data_ptr()
    assert args[16:18] == (0.0, 100.0)  # lb, ub
    assert args[18:20] == ((0, 0.0) if r2_threshold is None else (1, 0.9))
    assert args[20:23] == (0.0, mode, scale)  # nan_fill, round mode, scale


def _volumes(yT, shape, kind):
    affine = dt.to_affine(dt.SAGITTAL, spacing=(0.5, 0.5, 2.0))
    arrays = [r.reshape(shape) for r in yT]
    if kind == "host":
        return [dt.MedicalVolume(a, affine) for a in arrays]
    if kind == "tensors":
        return [dt.MedicalVolume(torch.from_numpy(a.copy()), affine) for a in arrays]
    stack = torch.from_numpy(yT.reshape((-1,) + shape).copy())  # views of one (T, ...) tensor
    return [dt.MedicalVolume(stack[t], affine) for t in range(stack.shape[0])]


@pytest.mark.parametrize("T", [4, 9])
def test_host_and_tensor_volumes_give_the_same_maps(T):
    shape = (10, 9, 4)
    _, yT = _echoes(T, True, N=int(np.prod(shape)), seed=5)
    x = _times(T, True)
    mask = _mask("uint8", yT.shape[1]).numpy().reshape(shape)
    fitter = dt.MonoExponentialFit(tc0="polyfit", bounds=(0, 100))
    before = counters["fit.echoes_in_place"]
    tc_h, r2_h = fitter.fit(x, _volumes(yT, shape, "host"), mask=mask)
    assert counters["fit.echoes_in_place"] == before  # host volumes are stacked
    assert isinstance(tc_h.A, np.ndarray)
    for kind in ("tensors", "views"):
        tc_t, r2_t = fitter.fit(x, _volumes(yT, shape, kind), mask=torch.from_numpy(mask))
        assert isinstance(tc_t.A, torch.Tensor)
        assert _bits_equal(tc_t.A, torch.from_numpy(tc_h.A))
        assert _bits_equal(r2_t.A, torch.from_numpy(r2_h.A))
    # On the CPU the plain version stacks the rows: no kernel read them.
    assert counters["fit.echoes_in_place"] == before
    assert (tc_h.A > 0).mean() > 0.2


@pytest.mark.parametrize("T", [4, 9])
def test_tensor_volumes_of_another_dtype_give_the_host_maps(T):
    # The fit casts echoes of any dtype to float32 in one place: CPU tensor
    # volumes of float64 and int32 give the maps of float32 host volumes
    # holding the same values, and so does the maps entry's plain version on
    # their rows.
    shape = (10, 9, 4)
    _, yT = _echoes(T, True, N=int(np.prod(shape)), seed=7)
    x = _times(T, True)
    mask = _mask("uint8", yT.shape[1]).numpy().reshape(shape)
    fitter = dt.MonoExponentialFit(tc0="polyfit", bounds=(0, 100), r2_threshold=0.9)
    before = counters["fit.echoes_in_place"]
    for values in (yT.astype(np.float64), np.round(1000 * yT).astype(np.int32)):
        tc_h, r2_h = fitter.fit(x, _volumes(values.astype(np.float32), shape, "host"), mask=mask)
        tc_t, r2_t = fitter.fit(x, _volumes(values, shape, "tensors"), mask=torch.from_numpy(mask))
        assert _bits_equal(tc_t.A, torch.from_numpy(tc_h.A))
        assert _bits_equal(r2_t.A, torch.from_numpy(r2_h.A))
        plain = monoexp_maps_reference(x, [torch.from_numpy(r) for r in values],
                                       bounds=(0, 100), r2_threshold=0.9, decimals=1,
                                       mask=mask.reshape(-1))
        assert _bits_equal(plain[0], tc_t.A.reshape(-1))
        assert _bits_equal(plain[1], r2_t.A.reshape(-1))
        assert (tc_h.A > 0).mean() > 0.2
    assert counters["fit.echoes_in_place"] == before
