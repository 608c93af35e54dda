"""The port's generic small-P fit against the JAX package's Pallas kernel,
and the code generator that turns a user's model into the CUDA kernel's.

The same numpy inputs (``numpy.random.RandomState``) go through
``dosma_tpu.ops.generic_lm_pallas.generic_lm_pallas`` in Pallas interpret
mode and through ``dosma_tpu_torch.ops.generic_lm`` on CPU tensors, which
takes the plain version (``generic_lm_reference``: the LM loop of
``lm_fit`` fed by a torch interpreter of the model's dual-number program).
Each model is written once in ``jax.numpy`` and once in ``torch``. The CUDA
kernel is held against the plain version on the card by ``chip_smoke.py``.

Tolerances:
  - noiseless data: |Δp| ≤ 2e-5 · max(1, |p|), r² within 1e-6. The JAX
    kernel keeps polishing a latched voxel until its block has latched; the
    port freezes each voxel at its latch. Both latches stop within ~1e-5
    relative of the optimum, which noiseless data pins tighter.
  - the noise-floor model ``sqrt((a e^{bx})² + c²)``: |Δp| ≤ 5e-3 · max(1,
    |p|), r² within 1e-4 and fitted curves within 5e-4 (2e-5 for the other
    models). The floor enters as c², so the cost is flat in c where the
    floor is small against the signal: the port, frozen at its latch, stops
    where the JAX kernel, still polishing, moves c on by that much.
  - 1% noise: |Δp| ≤ 1e-3 · max(1, |p|), r² within 1e-6 (the same latch
    difference on a flatter cost).
  - one step (``nan_policy="keep"``, ``max_iter=1``): |Δp| ≤ 1e-4 ·
    max(1, |p|), r² within 1e-5 (one damped step; the frameworks' float32
    transcendentals differ in the last bit).
  - NaN positions identical; converged flags equal on ≥ 99% of voxels.
  - dual-number derivatives against ``torch.func.jvp``: relative 1e-5 (the
    two apply the same derivative rules with operations in another order,
    e.g. ``(da - v·db) / b`` against autograd's quotient rule); values
    relative 1e-6.
"""

import math
import operator

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from dosma_tpu.ops.generic_lm_pallas import generic_lm_pallas
from dosma_tpu_torch.ops import _build
from dosma_tpu_torch.ops import generic_lm as G
from dosma_tpu_torch.ops.nlls import _JvpSource


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU."""
    from dosma_tpu_torch.core.device import default_device

    with default_device("cpu"):
        yield


_X5 = np.array([5.0, 15.0, 30.0, 50.0, 80.0], np.float32)

# name -> (jax model_fn(x_col, params), torch f(x, *params), p0, true-parameter sampler)
_MODELS = {
    "P1_rate": (
        lambda xc, p: jnp.exp(-xc / p[0]),
        lambda x, a: torch.exp(-x / a),
        [30.0],
        lambda rs, N: [rs.rand(N) * 70 + 10],
    ),
    "P2_amp_tc": (
        lambda xc, p: p[0] * jnp.exp(-xc / p[1]),
        lambda x, a, b: a * torch.exp(-x / b),
        [1.0, 30.0],
        lambda rs, N: [rs.rand(N) + 0.5, rs.rand(N) * 70 + 10],
    ),
    "P3_offset": (
        lambda xc, p: p[0] * jnp.exp(p[1] * xc) + p[2],
        lambda x, a, b, c: a * torch.exp(b * x) + c,
        [1.0, -1 / 30, 0.0],
        lambda rs, N: [rs.rand(N) + 0.5, -1 / (rs.rand(N) * 70 + 10), rs.rand(N) * 0.2],
    ),
    "P3_noise_floor": (
        lambda xc, p: jnp.sqrt((p[0] * jnp.exp(p[1] * xc)) ** 2 + p[2] ** 2),
        lambda x, a, b, c: torch.sqrt((a * torch.exp(b * x)) ** 2 + c ** 2),
        [1.0, -1 / 30, 0.05],
        lambda rs, N: [rs.rand(N) + 0.5, -1 / (rs.rand(N) * 70 + 10), 0.02 + 0.1 * rs.rand(N)],
    ),
    "P4_biexp": (
        lambda xc, p: p[0] * jnp.exp(p[1] * xc) + p[2] * jnp.exp(p[3] * xc),
        lambda x, a1, b1, a2, b2: a1 * torch.exp(b1 * x) + a2 * torch.exp(b2 * x),
        [0.8, -0.2, 0.4, -0.01],
        lambda rs, N: [0.8 + 0.4 * rs.rand(N), -(0.15 + 0.1 * rs.rand(N)),
                       0.3 + 0.3 * rs.rand(N), -(0.008 + 0.006 * rs.rand(N))],
    ),
}


def _data(model, N=256, seed=0, noise=0.0, x=_X5):
    rs = np.random.RandomState(seed)
    _, ft, _, sample = _MODELS[model]
    truth = [torch.from_numpy(v.astype(np.float32)) for v in sample(rs, N)]
    Y = ft(torch.from_numpy(x)[:, None], *truth).T.numpy()
    if noise:
        Y = Y + noise * rs.randn(*Y.shape)
    return x, np.ascontiguousarray(Y, dtype=np.float32)


def _run_both(model, x, Y, p0, kw):
    fj, ft, _, _ = _MODELS[model]
    with pltpu.force_tpu_interpret_mode():
        pj, rj, cj = generic_lm_pallas(fj, x, Y, p0, **kw)
    launches = G.generic_lm.launches
    pt, rt, ct = G.generic_lm(ft, x, torch.from_numpy(Y), p0, **kw)
    assert G.generic_lm.launches == launches  # a CPU tensor never reaches the kernel
    return (np.asarray(pj), np.asarray(rj), np.asarray(cj)), (pt.numpy(), rt.numpy(), ct.numpy())


def _check(jax_out, torch_out, ptol, r2tol):
    (pj, rj, cj), (pt, rt, ct) = jax_out, torch_out
    assert pt.shape == pj.shape and rt.shape == rj.shape and ct.shape == cj.shape
    np.testing.assert_array_equal(np.isnan(pt), np.isnan(pj))
    fin = np.isfinite(pj)
    assert (np.abs(pt - pj)[fin] <= ptol * np.maximum(1.0, np.abs(pj[fin]))).all()
    assert np.abs(rt - rj).max() <= r2tol
    assert (ct == cj).mean() >= 0.99


@pytest.mark.parametrize("model", list(_MODELS))
def test_matches_jax_kernel_per_model(model):
    x, Y = _data(model, seed=1)
    p0 = np.array(_MODELS[model][2], np.float32)
    jax_out, torch_out = _run_both(model, x, Y, p0, {"max_iter": 100})
    _check(jax_out, torch_out, 5e-3 if model == "P3_noise_floor" else 2e-5, 1e-4)
    assert torch_out[2].mean() > 0.9
    # Same fitted curves.
    ft = _MODELS[model][1]
    xc = torch.from_numpy(x)[:, None]
    curves = [ft(xc, *torch.from_numpy(np.nan_to_num(out[0])).T) for out in (jax_out, torch_out)]
    atol = 5e-4 if model == "P3_noise_floor" else 2e-5
    torch.testing.assert_close(curves[1], curves[0], rtol=0, atol=atol)


@pytest.mark.parametrize(
    "case",
    ["noisy", "all_zero_voxel", "y_bounds", "keep_one_iter", "n_not_multiple_of_block",
     "per_voxel_p0", "bad_init_voxel", "layout_tn", "T2", "T8", "T11"],
)
def test_matches_jax_kernel_edge_cases(case):
    model = "P2_amp_tc" if case.startswith("T") else "P3_offset"
    p0 = np.array(_MODELS[model][2], np.float32)
    kw = {"max_iter": 60}
    ptol, r2tol = 2e-5, 1e-6
    N = 300 if case == "n_not_multiple_of_block" else 256
    x = (10.0 * np.arange(1, int(case[1:]) + 1)).astype(np.float32) if case.startswith("T") else _X5
    x, Y = _data(model, N=N, seed=2, noise=0.01 if case == "noisy" else 0.0, x=x)
    if case == "noisy":
        ptol = 1e-3
    elif case == "all_zero_voxel":
        Y[7] = 0
    elif case == "y_bounds":
        kw["y_bounds"] = (0.2, 1.5)
    elif case == "keep_one_iter":
        kw.update(nan_policy="keep", max_iter=1)
        ptol, r2tol = 1e-4, 1e-5
    elif case == "per_voxel_p0":
        p0 = np.tile(p0, (N, 1)) * np.float32(1.1)
    elif case == "bad_init_voxel":
        p0 = np.tile(p0, (N, 1))
        p0[5, 1] = 100.0  # exp(100 * 80) overflows: the initial cost is inf
    elif case == "layout_tn":
        Y = np.ascontiguousarray(Y.T)
        kw["y_layout"] = "tn"
    jax_out, torch_out = _run_both(model, x, Y, p0, kw)
    _check(jax_out, torch_out, ptol, r2tol)
    pt, rt, ct = torch_out
    if case == "all_zero_voxel":
        assert np.isnan(pt[7]).all() and rt[7] == 0
    if case == "y_bounds":
        oob = ((Y < 0.2) | (Y > 1.5)).any(1)
        assert oob.any() and np.isnan(pt[oob]).all() and (rt[oob] == 0).all()
    if case == "keep_one_iter":
        assert (~ct).any() and np.isfinite(pt).all()
    if case == "bad_init_voxel":
        assert np.isnan(pt[5]).all() and not ct[5] and ct.mean() > 0.9


def test_reference_entry_point_equals_cpu_dispatch():
    x, Y = _data("P3_offset", N=64, seed=3, noise=0.01)
    f = _MODELS["P3_offset"][1]
    p0 = np.array(_MODELS["P3_offset"][2], np.float32)
    a = G.generic_lm(f, x, torch.from_numpy(Y), p0)
    b = G.generic_lm_reference(G.compile_model(f, 3), x, torch.from_numpy(Y), p0)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0, equal_nan=True)


# ----------------------------------------------------------------------
# The code generator: acceptance, refusal, derivative rules, CUDA source.
# ----------------------------------------------------------------------
_WHITELISTED = {
    "add_dd": lambda x, a, b: a * x + b,
    "add_df_fd": lambda x, a, b: (a + 2.0) * (3.0 + b) + x,
    "sub_dd_df_fd": lambda x, a, b: (a - b) * (a - 0.5) + (1.5 - b) * x,
    "mul_dd": lambda x, a, b: a * b * x,
    "div_dd": lambda x, a, b: (a * x) / (b + 2.0),
    "div_df": lambda x, a, b: (a * x + b) / 7.0,
    "div_fd": lambda x, a, b: x / (a * a + 1.0) + 3.0 / (b + 2.0),
    "neg": lambda x, a, b: -(a * x) + -b,
    "pow_2_3": lambda x, a, b: (a * x) ** 2 + b ** 3,
    "pow_half_minus1": lambda x, a, b: (a * a + x) ** 0.5 + (b + 2.0) ** -1,
    "pow_2_5_and_1": lambda x, a, b: (a * a + 1.0) ** 2.5 * x + (b * x) ** 1,
    "exp": lambda x, a, b: torch.exp(a * x) + b,
    "log": lambda x, a, b: torch.log(a * a * x + 1.0) * b,
    "sqrt": lambda x, a, b: torch.sqrt(a * a + x * b * b),
    "abs": lambda x, a, b: torch.abs(a * x - 1.0) + abs(b - 0.25),
    "sin_cos": lambda x, a, b: torch.sin(a * x) + torch.cos(b * x),
    "tanh": lambda x, a, b: torch.tanh(a * x + b),
    "numpy_float64_constant": lambda x, a, b: a * np.float64(0.5) * x + b,
    "x_only_term": lambda x, a, b: torch.exp(-x / 30.0) + a * x + b,
}


@pytest.mark.parametrize("name", list(_WHITELISTED))
def test_dual_program_matches_torch_jvp(name):
    f = _WHITELISTED[name]
    program = G.compile_model(f, 2)
    assert program.nparams == 2 and len(program.ops) >= 1
    rs = np.random.RandomState(len(name))
    x_col = torch.from_numpy(np.linspace(0.5, 3.0, 6).astype(np.float32))[:, None]
    params = [torch.from_numpy((rs.rand(32) + 0.3).astype(np.float32)) for _ in range(2)]

    value = G.run_program(program, x_col, params, dual=False)
    dual = G.run_program(program, x_col, params, dual=True)
    direct = torch.broadcast_to(f(x_col, *params), (6, 32))
    torch.testing.assert_close(torch.broadcast_to(value, (6, 32)), direct, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(torch.broadcast_to(dual.v, (6, 32)), direct, rtol=1e-6, atol=1e-7)

    _, cols = _JvpSource(lambda xc, ps: f(xc, *ps), x_col, (6, 32)).value_and_jacobian(params)
    for d, col in zip(dual.d, cols):
        torch.testing.assert_close(torch.broadcast_to(d, (6, 32)), col, rtol=1e-5, atol=1e-6)


def test_library_models_are_accepted():
    from dosma_tpu_torch.core.fitting import biexponential, monoexponential

    assert G.compile_model(monoexponential, 2).nparams == 2
    program = G.compile_model(biexponential, 4)
    assert [op for op, _ in program.ops].count("exp") == 2


def _branchy(x, a, b):
    if a > 0:  # data-dependent control flow does not trace
        return a * x
    return b * x


_REFUSED = {
    "where": (lambda x, a, b: torch.where(x > a, a * x, b), 2, "whitelist"),
    "clamp_kwargs": (lambda x, a, b: torch.clamp(a * x, min=0.0) + b, 2, "whitelist"),
    "method_call": (lambda x, a, b: (a * x).exp() + b, 2, "whitelist"),
    "param_exponent": (lambda x, a, b: x ** a + b, 2, "whitelist"),
    "math_exp": (lambda x, a, b: a * math.exp(1.0) * x + b, 2, None),
    "branch": (_branchy, 2, "trace"),
    "numpy_float32_constant": (lambda x, a, b: a * np.float32(0.5) * x + b, 2, "trace"),
    "too_many_params": (lambda x, a, b, c, d, e: a + b + c + d + e * x, 5, "P = 5"),
    "constant_output": (lambda x, a, b: 1.0, 2, "not one tensor"),
}


@pytest.mark.parametrize("name", list(_REFUSED))
def test_refused_models(name):
    f, nparams, words = _REFUSED[name]
    if name == "math_exp":
        # math.exp(1.0) is a Python float at trace time: the model is accepted.
        assert G.compile_model(f, nparams).nparams == 2
        return
    with pytest.raises(G.ModelRefused, match=words):
        G.compile_model(f, nparams)


def test_refusal_names_the_node():
    with pytest.raises(G.ModelRefused, match=r"operator\.gt"):
        G.compile_model(_REFUSED["where"][0], 2)


def test_cuda_source_of_a_program():
    program = G.compile_model(_MODELS["P3_offset"][1], 3)
    src = program.cuda_source
    assert '#include "generic_lm.cuh"' in src
    assert "static constexpr int P = 3;" in src
    assert "dosma::op_exp(" in src and "dosma::generic_lm_launch<Model>" in src
    assert 'extern "C" int dosma_generic_lm(' in src
    # Constants are emitted as the bits of their float32 value.
    src2 = G.compile_model(lambda x, a: a * x + 0.1, 1).cuda_source
    assert f"0x{int(np.float32(0.1).view(np.uint32)):08x}" in src2

    # One library per distinct generated text: the cache key follows the text.
    flags = _build._nvcc_flags(False)
    key = _build._digest(flags, "generic_lm_p3", src.encode())
    assert key == _build._digest(flags, "generic_lm_p3", program.cuda_source.encode())
    other = G.compile_model(lambda x, a, b, c: a * torch.exp(b * x) - c, 3).cuda_source
    assert key != _build._digest(flags, "generic_lm_p3", other.encode())


def test_binary_ops_cover_operator_module():
    # The whitelist is what the docstring and the kernel header say it is.
    assert set(G._BINARY) == {operator.add, operator.sub, operator.mul, operator.truediv}
    assert {G._UNARY[f] for f in (torch.exp, torch.log, torch.sqrt, torch.abs, torch.sin,
                                  torch.cos, torch.tanh)} == {
        "exp", "log", "sqrt", "abs", "sin", "cos", "tanh"}


def test_rejects_wrong_shapes():
    x, Y = _data("P2_amp_tc", N=16)
    f = _MODELS["P2_amp_tc"][1]
    with pytest.raises(ValueError):
        G.generic_lm(f, x[:3], torch.from_numpy(Y), [1.0, 30.0])
    with pytest.raises(ValueError):
        G.generic_lm(G.compile_model(f, 2), x, torch.from_numpy(Y), np.ones((5, 2), np.float32))
