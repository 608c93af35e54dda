"""Generic small-P Levenberg–Marquardt: a CUDA kernel generated per model,
and its plain version.

Counterpart of ``dosma_tpu/ops/generic_lm_pallas.py``, which traces the
user's model inside a Pallas kernel. A hand-written CUDA kernel takes the
model as code instead:

1. :func:`compile_model` traces ``f(x, *params)`` with ``torch.fx`` and
   accepts it only if every node is a whitelisted operation — ``+ - * /``,
   unary minus, ``**`` with a constant exponent, ``torch.exp/log/sqrt/abs/
   sin/cos/tanh`` (and the builtin ``abs``) — on the inputs and float
   constants, with P ≤ :data:`MAX_P` parameters. Anything else raises
   :class:`ModelRefused`, whose message names the refused node. The decision
   is made on the model, before any build or launch.
2. An accepted model becomes a :class:`ModelProgram`: straight-line code
   that ``csrc/generic_lm.cuh`` evaluates on floats or on forward-mode dual
   numbers (a value and its P derivatives: the Jacobian columns in one pass,
   where the JAX kernel takes P one-hot ``jax.jvp`` passes). Its CUDA
   source is built once per distinct text (``_build.load_generated``).
3. :func:`generic_lm_reference`, the plain version, runs the LM loop of
   :func:`dosma_tpu_torch.ops.nlls.lm_fit` fed by a torch interpreter of
   the same dual-number program, so kernel and plain version compute every
   value and derivative with the same operations.

:func:`generic_lm` launches the kernel for a tensor on a CUDA card (a failed
build or launch raises) and runs the plain version for a tensor on the CPU.
"""

from __future__ import annotations

import ctypes
import operator
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from dosma_tpu_torch.ops.nlls import _apply_nan_policy, _finish, _lm_loop

__all__ = [
    "MAX_P",
    "ModelProgram",
    "ModelRefused",
    "build_kernel",
    "compile_model",
    "generic_lm",
    "generic_lm_reference",
]

MAX_P = 4

_BINARY = {operator.add: "add", operator.sub: "sub", operator.mul: "mul", operator.truediv: "div"}
_UNARY = {
    operator.neg: "neg",
    operator.abs: "abs",
    torch.exp: "exp",
    torch.log: "log",
    torch.sqrt: "sqrt",
    torch.abs: "abs",
    torch.sin: "sin",
    torch.cos: "cos",
    torch.tanh: "tanh",
}


class ModelRefused(ValueError):
    """The generic kernel does not take this model (the message says why)."""


@dataclass(frozen=True)
class ModelProgram:
    """A whitelisted model as straight-line code.

    ``ops[k] = (name, args)``; each argument (and ``out``) is ``("x",)``,
    ``("p", i)`` for parameter i, ``("c", value)`` for a float32 constant
    or ``("v", k)`` for the result of ``ops[k]``. The exponent of ``"pow"``
    is always a constant.
    """

    nparams: int
    ops: tuple
    out: tuple
    name: str = "model"

    @property
    def cuda_source(self) -> str:
        return _cuda_source(self)


def _number(a) -> bool:
    return isinstance(a, (int, float)) and not isinstance(a, bool)


def compile_model(func: Callable, nparams: int) -> ModelProgram:
    """Trace ``func(x, *params)`` and check it against the whitelist.

    Raises :class:`ModelRefused` (naming the node or the reason) when the
    generic kernel cannot take the model.
    """
    name = getattr(func, "__name__", type(func).__name__)
    if not 1 <= nparams <= MAX_P:
        raise ModelRefused(f"{name} has P = {nparams} parameters; the kernel takes 1 to {MAX_P}")
    try:
        graph = torch.fx.symbolic_trace(func).graph
    except Exception as e:  # any failure to trace is a refusal, decided before a build
        raise ModelRefused(f"torch.fx cannot trace {name} ({type(e).__name__}: {e})") from None

    placeholders = [n for n in graph.nodes if n.op == "placeholder"]
    if len(placeholders) != nparams + 1:
        raise ModelRefused(
            f"{name} traces to {len(placeholders)} inputs, not x and {nparams} parameters"
        )
    env = {placeholders[0]: ("x",)}
    env.update({node: ("p", i) for i, node in enumerate(placeholders[1:])})

    def operand(a, node):
        if isinstance(a, torch.fx.Node):
            return env[a]
        if _number(a):
            return ("c", float(np.float32(a)))
        raise ModelRefused(f"node `{node.format_node()}`: argument {a!r} is not a node or a number")

    ops, out = [], None
    for node in graph.nodes:
        if node.op == "placeholder":
            continue
        if node.op == "output":
            res = node.args[0]
            if not isinstance(res, torch.fx.Node):
                raise ModelRefused(f"{name} returns {res!r}, not one tensor")
            out = env[res]
            continue
        t, args = node.target, node.args
        if node.op != "call_function" or node.kwargs:
            op = None
        elif t in _BINARY and len(args) == 2:
            op = (_BINARY[t], (operand(args[0], node), operand(args[1], node)))
        elif t in _UNARY and len(args) == 1:
            op = (_UNARY[t], (operand(args[0], node),))
        elif t is operator.pow and len(args) == 2 and _number(args[1]):
            op = ("pow", (operand(args[0], node), operand(args[1], node)))
        else:
            op = None
        if op is None:
            raise ModelRefused(f"node `{node.format_node()}` is not in the kernel's whitelist")
        ops.append(op)
        env[node] = ("v", len(ops) - 1)
    return ModelProgram(nparams=nparams, ops=tuple(ops), out=out, name=name)


# ----------------------------------------------------------------------
# Code generation
# ----------------------------------------------------------------------
def _c_operand(a) -> str:
    kind = a[0]
    if kind == "x":
        return "x"
    if kind == "p":
        return f"p[{a[1]}]"
    if kind == "v":
        return f"v{a[1]}"
    bits = int(np.float32(a[1]).view(np.uint32))
    return f"__int_as_float(0x{bits:08x}) /* {a[1]!r} */"


def _cuda_source(program: ModelProgram) -> str:
    lines = [
        f"// Generated by dosma_tpu_torch/ops/generic_lm.py from the model `{program.name}`.",
        '#include "generic_lm.cuh"',
        "",
        "namespace {",
        "struct Model {",
        f"  static constexpr int P = {program.nparams};",
        "  template <class V>",
        "  __device__ __forceinline__ static V eval(float x, const V* p) {",
    ]
    for k, (name, args) in enumerate(program.ops):
        lines.append(f"    const auto v{k} = dosma::op_{name}({', '.join(map(_c_operand, args))});")
    lines += [
        f"    return dosma::Lift<V>::from({_c_operand(program.out)});",
        "  }",
        "};",
        "}  // namespace",
        "",
        'extern "C" int dosma_generic_lm(const float* x, const float* y, long long y_st,',
        "                                long long y_sn, const float* p0, long long p0_sp,",
        "                                long long p0_sn, float* out, long long N, int T,",
        "                                int max_iter, float ftol, float xtol, void* stream) {",
        "  return dosma::generic_lm_launch<Model>(x, y, y_st, y_sn, p0, p0_sp, p0_sn, out, N, T,",
        "                                         max_iter, ftol, xtol, stream);",
        "}",
        "",
    ]
    return "\n".join(lines)


# ----------------------------------------------------------------------
# The torch interpreter of a program (the plain version's model source)
# ----------------------------------------------------------------------
class _Dual:
    """A value and its P derivatives (tensors), as ``dosma::Dual<P>``."""

    __slots__ = ("v", "d")

    def __init__(self, v, d):
        self.v = v
        self.d = d


def _cpow(a, c: float, const):
    if c == 1.0:
        return a
    if c == 2.0:
        return a * a
    if c == 3.0:
        return a * a * a
    if c == 0.5:
        return torch.sqrt(a)
    if c == -1.0:
        return const(1.0) / a
    return torch.pow(a, const(c))


def _op(name: str, args, const):
    """One operation of ``csrc/generic_lm.cuh`` on tensors or :class:`_Dual`s,
    each with the same arithmetic as its CUDA counterpart."""
    if name == "pow":
        a, c = args[0], args[1]
        if not isinstance(a, _Dual):
            return _cpow(a, c, const)
        v = _cpow(a.v, c, const)
        if c == 1.0:
            return _Dual(v, a.d)
        k = const(c) * _cpow(a.v, float(np.float32(c) - np.float32(1.0)), const)
        return _Dual(v, [k * di for di in a.d])
    if len(args) == 2:
        a, b = args
        da, db = isinstance(a, _Dual), isinstance(b, _Dual)
        if name == "add":
            if da and db:
                return _Dual(a.v + b.v, [x + y for x, y in zip(a.d, b.d)])
            if da:
                return _Dual(a.v + b, a.d)
            if db:
                return _Dual(a + b.v, b.d)
            return a + b
        if name == "sub":
            if da and db:
                return _Dual(a.v - b.v, [x - y for x, y in zip(a.d, b.d)])
            if da:
                return _Dual(a.v - b, a.d)
            if db:
                return _Dual(a - b.v, [-y for y in b.d])
            return a - b
        if name == "mul":
            if da and db:
                return _Dual(a.v * b.v, [x * b.v + a.v * y for x, y in zip(a.d, b.d)])
            if da:
                return _Dual(a.v * b, [x * b for x in a.d])
            if db:
                return _Dual(a * b.v, [a * y for y in b.d])
            return a * b
        # div
        if da and db:
            v = a.v / b.v
            return _Dual(v, [(x - v * y) / b.v for x, y in zip(a.d, b.d)])
        if da:
            return _Dual(a.v / b, [x / b for x in a.d])
        if db:
            v = a / b.v
            return _Dual(v, [(-(v * y)) / b.v for y in b.d])
        return a / b
    (a,) = args
    if not isinstance(a, _Dual):
        return _VALUE_FNS[name](a)
    if name == "neg":
        return _Dual(-a.v, [-x for x in a.d])
    if name == "exp":
        v = torch.exp(a.v)
        return _Dual(v, [v * x for x in a.d])
    if name == "log":
        return _Dual(torch.log(a.v), [x / a.v for x in a.d])
    if name == "sqrt":
        v = torch.sqrt(a.v)
        return _Dual(v, [x / (v + v) for x in a.d])
    if name == "abs":
        s = (a.v > 0).to(a.v.dtype) - (a.v < 0).to(a.v.dtype)
        return _Dual(torch.abs(a.v), [s * x for x in a.d])
    if name == "sin":
        c = torch.cos(a.v)
        return _Dual(torch.sin(a.v), [c * x for x in a.d])
    if name == "cos":
        s = -torch.sin(a.v)
        return _Dual(torch.cos(a.v), [s * x for x in a.d])
    # tanh
    v = torch.tanh(a.v)
    k = 1.0 - v * v
    return _Dual(v, [k * x for x in a.d])


_VALUE_FNS = {
    "neg": torch.neg, "exp": torch.exp, "log": torch.log, "sqrt": torch.sqrt,
    "abs": torch.abs, "sin": torch.sin, "cos": torch.cos, "tanh": torch.tanh,
}


def run_program(program: ModelProgram, x_col: torch.Tensor, params, dual: bool):
    """Evaluate ``program`` at (T, 1) ``x_col`` and P (N,) ``params``.

    Returns a tensor (``dual=False``) or a :class:`_Dual` whose derivatives
    are taken with respect to the P parameters (``dual=True``). Constants
    are tensors on ``x_col``'s device, so a division by one is a true
    division, as in the kernel.
    """
    consts = {}

    def const(c: float) -> torch.Tensor:
        if c not in consts:
            consts[c] = torch.tensor(c, dtype=x_col.dtype, device=x_col.device)
        return consts[c]

    if dual:
        P = len(params)
        ps = [
            _Dual(p, [torch.ones_like(p) if i == j else torch.zeros_like(p) for i in range(P)])
            for j, p in enumerate(params)
        ]
    else:
        ps = list(params)
    vals = []

    def get(a):
        kind = a[0]
        if kind == "x":
            return x_col
        if kind == "p":
            return ps[a[1]]
        if kind == "c":
            return const(a[1])
        return vals[a[1]]

    for name, args in program.ops:
        if name == "pow":
            vals.append(_op(name, (get(args[0]), args[1][1]), const))
        else:
            vals.append(_op(name, tuple(get(a) for a in args), const))
    res = get(program.out)
    if dual and not isinstance(res, _Dual):
        res = _Dual(res, [torch.zeros_like(res) for _ in range(len(params))])
    return res


class _ProgramSource:
    """Model values and Jacobian columns of a program, for ``nlls._lm_loop``."""

    def __init__(self, program: ModelProgram, x_col: torch.Tensor, shape):
        self.program = program
        self.x_col = x_col
        self.shape = shape

    def value(self, params):
        return torch.broadcast_to(run_program(self.program, self.x_col, params, False), self.shape)

    def value_and_jacobian(self, params):
        f = run_program(self.program, self.x_col, params, True)
        return (
            torch.broadcast_to(f.v, self.shape),
            [torch.broadcast_to(d, self.shape) for d in f.d],
        )


def _reference_rows(program, x, yT, p0, max_iter, ftol, xtol) -> torch.Tensor:
    T, N = yT.shape
    params = [p0[i].expand(N).clone() if p0.ndim == 1 else p0[:, i].clone()
              for i in range(program.nparams)]
    source = _ProgramSource(program, x[:, None], (T, N))
    params, latched, bad_init = _lm_loop(
        source, yT, params, max_iter, ftol, xtol, latch_bad_init=True
    )
    return _finish(source, yT, params, latched, bad_init)


# ----------------------------------------------------------------------
# CUDA kernel
# ----------------------------------------------------------------------
def build_kernel(program: ModelProgram):
    """Build (or load from the cache) the kernel of ``program``; returns its
    library, whose ``build_seconds`` and ``build_log`` report the build."""
    from dosma_tpu_torch.ops._build import load_generated

    return load_generated(f"generic_lm_p{program.nparams}", program.cuda_source)


def _kernel_fn(program: ModelProgram):
    fn = build_kernel(program).dosma_generic_lm
    if fn.argtypes is None:
        vp, ll, ci, cf = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, vp, ll, ll, vp, ll, ll, vp, ll, ci, ci, cf, cf, vp]
        fn.restype = ci
    return fn


def _packed_kernel(program, x, yT, p0, max_iter, ftol, xtol) -> torch.Tensor:
    """Launch the program's kernel on the current stream: packed (P + 2, N)."""
    T, N = yT.shape
    P = program.nparams
    out = torch.empty((P + 2, N), dtype=torch.float32, device=yT.device)
    fn = _kernel_fn(program)
    if p0.ndim == 1:
        p0_sp, p0_sn = p0.stride(0), 0
    else:
        p0_sp, p0_sn = p0.stride(1), p0.stride(0)
    with torch.cuda.device(yT.device):
        stream = torch.cuda.current_stream().cuda_stream
        generic_lm.launches += 1
        err = fn(
            x.data_ptr(), yT.data_ptr(), yT.stride(0), yT.stride(1),
            p0.data_ptr(), p0_sp, p0_sn, out.data_ptr(), N, T,
            int(max_iter), float(ftol), float(xtol), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"generic_lm kernel launch failed for {program.name}: "
            f"{torch.cuda.get_device_name(yT.device)} reported CUDA error {err}"
        )
    return out


# ----------------------------------------------------------------------
# Public wrappers
# ----------------------------------------------------------------------
def _fit(packed: Optional[Callable], model, x, y, p0, max_iter, ftol, xtol, y_bounds, nan_policy,
         y_layout):
    if not isinstance(model, ModelProgram):
        p0_shape = np.shape(p0) if not isinstance(p0, torch.Tensor) else tuple(p0.shape)
        model = compile_model(model, int(p0_shape[-1]))
    P = model.nparams
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()  # (T,) sample positions: a few bytes
    x_host = np.asarray(x, np.float32)

    if not isinstance(y, torch.Tensor):
        y = torch.from_numpy(np.ascontiguousarray(y))
    yT = y.T if y_layout != "tn" else y
    if yT.ndim != 2 or yT.shape[0] != x_host.shape[0]:
        raise ValueError(f"y must be (N, {x_host.shape[0]}) for y_layout={y_layout!r}")
    if yT.dtype != torch.float32:
        yT = yT.to(torch.float32)
    device = yT.device
    if packed is None:
        if device.type == "cuda":
            packed = _packed_kernel
        elif device.type == "cpu":
            packed = _reference_rows
        else:
            raise ValueError(f"generic_lm runs on cpu or cuda tensors, got {device}")
    T, N = yT.shape

    p0_t = torch.as_tensor(p0, dtype=torch.float32, device=device)
    if tuple(p0_t.shape) not in ((P,), (N, P)):
        raise ValueError(f"p0 must be ({P},) or ({N}, {P}), got {tuple(p0_t.shape)}")

    if N == 0:
        rows = torch.empty((P + 2, 0), dtype=torch.float32, device=device)
    else:
        x_dev = torch.as_tensor(x_host, device=device)
        rows = packed(model, x_dev, yT, p0_t, int(max_iter), float(ftol), float(xtol))
    return _apply_nan_policy(rows, yT, P, y_bounds, nan_policy)


def generic_lm(
    model: Union[ModelProgram, Callable],
    x,
    y,
    p0,
    max_iter: int = 50,
    ftol: float = 1e-5,
    xtol: float = 1e-5,
    y_bounds: Optional[Tuple[float, float]] = None,
    nan_policy: str = "scipy",
    y_layout: str = "nt",
):
    """Per-voxel LM fit of a whitelisted model with P ≤ 4 parameters.

    Args:
        model: ``f(x, *params)`` written in the whitelisted torch operations
            (compiled with :func:`compile_model`, which raises
            :class:`ModelRefused` for any other model), or a
            :class:`ModelProgram`.
        x: (T,) sample positions (host array or tensor).
        y: (N, T) data, or (T, N) with ``y_layout="tn"``; a CUDA tensor is
            fit by the model's kernel, a CPU tensor or numpy array by the
            plain version. Any strides are read in place.
        p0: (P,) or (N, P) seeds.
        max_iter, ftol, xtol, y_bounds, nan_policy: as
            :func:`dosma_tpu_torch.ops.nlls.lm_fit`.

    Returns:
        (popt (N, P), r2 (N,), converged (N,) bool), on ``y``'s device.
    """
    return _fit(None, model, x, y, p0, max_iter, ftol, xtol, y_bounds, nan_policy, y_layout)


generic_lm.launches = 0  # kernel launches; only _packed_kernel adds to it


def generic_lm_reference(
    model: Union[ModelProgram, Callable],
    x,
    y,
    p0,
    max_iter: int = 50,
    ftol: float = 1e-5,
    xtol: float = 1e-5,
    y_bounds: Optional[Tuple[float, float]] = None,
    nan_policy: str = "scipy",
    y_layout: str = "nt",
):
    """:func:`generic_lm` computed by the plain PyTorch version on any device."""
    return _fit(
        _reference_rows, model, x, y, p0, max_iter, ftol, xtol, y_bounds, nan_policy, y_layout
    )
