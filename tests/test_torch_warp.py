"""The port's full-grid warp against ``dosma_tpu.ops.warp_pallas``.

The same numpy volumes and matrices go through

- ``_warp_grid_pallas`` (the TPU kernel, in Pallas interpret mode) on the
  operands of ``dosma_tpu.ops.warp_pallas._prepare``, its padded output
  cropped; the kernel's 24-wide input blocks need sources of at least
  20x20 and transforms whose per-tile span fits them (no permutations);
- ``_xla_fallback``, the gather samplers ``dosma_tpu`` runs elsewhere;
- the port's :func:`warp_grid_batched` on CPU tensors, which computes the
  plain version of ``csrc/warp_grid.cu`` (the kernel itself is held
  against it on the card by ``chip_smoke.py``).

Tolerance: |Δ| ≤ 1e-5 · max(1, max|src|): the three formulations (dense
banded weights on the MXU, row profiles, 8 or 64 point gathers) do the
same arithmetic up to summation order; the JAX kernel and its fallback
agree to ~3e-6 on such inputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from dosma_tpu.ops import warp_pallas
from dosma_tpu_torch.ops import warp
from dosma_tpu_torch.utils.profiling import counters


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU."""
    from dosma_tpu_torch.core.device import default_device

    with default_device("cpu"):
        yield


def _vols(nb, shape, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.rand(nb, *shape) * 4.0 - 1.0).astype(np.float32)


def _rotation_B(shape, deg, shift, scale=1.0):
    """Index-space map: rotation about axis 2 around the volume centre,
    an isotropic scale and a shift (3x4)."""
    a = np.deg2rad(deg)
    R = scale * np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1.0]])
    c = (np.asarray(shape) - 1) / 2.0
    return np.concatenate([R, (c - R @ c + np.asarray(shift))[:, None]], axis=1).astype(np.float32)


# name -> (NB, source shape, output shape, B)
_PALLAS_CASES = {
    "identity": (2, (20, 21, 6), (20, 21, 6), np.eye(4, dtype=np.float32)[:3]),
    "rotation_shift": (2, (22, 20, 7), (22, 20, 7), _rotation_B((22, 20, 7), 3.0, (0.7, -1.3, 0.4))),
    "nb1": (1, (20, 20, 5), (20, 20, 5), _rotation_B((20, 20, 5), -2.0, (0.3, 0.2, -0.6))),
    "nb3": (3, (20, 20, 5), (20, 20, 5), _rotation_B((20, 20, 5), 2.5, (-0.4, 0.9, 0.1))),
    "partly_outside": (2, (20, 22, 6), (20, 22, 6), _rotation_B((20, 22, 6), 1.0, (6.5, -5.2, 2.3), 1.1)),
    "other_output_shape": (2, (22, 20, 7), (19, 23, 5), _rotation_B((22, 20, 7), 1.5, (0.5, -0.5, 0.8))),
}

_PERMUTATION = np.array([[0, 0, 1, 2.5], [0, 1, 0, 0.5], [1, 0, 0, -1.0]], np.float32)
# name -> (NB, source shape, output shape, B): the fallback only
_FALLBACK_CASES = dict(_PALLAS_CASES)
_FALLBACK_CASES["axis_permutation"] = (2, (9, 8, 10), (10, 8, 9), _PERMUTATION)
_FALLBACK_CASES["nb9"] = (9, (10, 9, 6), (11, 7, 5), _rotation_B((10, 9, 6), 4.0, (0.2, 0.3, 0.1)))


def _port(vols, B, out_shape, order):
    return warp.warp_grid_batched(torch.from_numpy(vols), torch.from_numpy(B), out_shape,
                                  order).numpy()


def _check(got, ref, vols):
    assert got.shape == ref.shape
    tol = 1e-5 * max(1.0, float(np.abs(vols).max()))
    err = float(np.abs(got - np.asarray(ref, np.float64)).max())
    assert err <= tol, f"max |Δ| {err} > {tol}"


@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("case", sorted(_PALLAS_CASES))
def test_plain_version_matches_pallas_kernel(case, order):
    nb, src_shape, out_shape, B = _PALLAS_CASES[case]
    vols = _vols(nb, src_shape, seed=len(case))
    with pltpu.force_tpu_interpret_mode():
        ref = warp_pallas._warp_grid_pallas(
            warp_pallas._prepare(jnp.asarray(vols), order), jnp.asarray(B), out_shape, order)
    ref = np.asarray(ref)[:, :out_shape[0], :out_shape[1], :out_shape[2]]
    _check(_port(vols, B, out_shape, order), ref, vols)


@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("case", sorted(_FALLBACK_CASES))
def test_plain_version_matches_gather_fallback(case, order):
    nb, src_shape, out_shape, B = _FALLBACK_CASES[case]
    vols = _vols(nb, src_shape, seed=len(case) + 1)
    ref = np.asarray(warp_pallas._xla_fallback(jnp.asarray(vols), jnp.asarray(B), out_shape, order))
    _check(_port(vols, B, out_shape, order), ref, vols)


def test_identity_reproduces_the_volumes():
    vols = _vols(3, (5, 6, 7), seed=3)
    for order in (1, 3):
        got = _port(vols, np.eye(4, dtype=np.float32), (5, 6, 7), order)
        np.testing.assert_allclose(got, vols, atol=1e-5 * np.abs(vols).max())


def test_one_transform_per_group():
    # (G, 3, 4): group g warps volumes g*V .. (g+1)*V-1 with its own matrix.
    vols = _vols(4, (8, 7, 6), seed=4)
    Bs = np.stack([_rotation_B((8, 7, 6), 5.0, (0.5, 0, 0)),
                   _rotation_B((8, 7, 6), -3.0, (0, 0.7, 0.2))])
    for order in (1, 3):
        got = _port(vols, Bs, (8, 7, 6), order)
        want = np.concatenate([_port(vols[:2], Bs[0], (8, 7, 6), order),
                               _port(vols[2:], Bs[1], (8, 7, 6), order)])
        np.testing.assert_array_equal(got, want)


def test_plain_version_chunks_points(monkeypatch):
    vols = _vols(2, (6, 5, 7), seed=5)
    B = _rotation_B((6, 5, 7), 7.0, (0.3, -0.2, 0.5))
    whole = [_port(vols, B, (6, 5, 7), order) for order in (1, 3)]
    monkeypatch.setattr(warp, "_POINT_CHUNK", 37)
    for order, want in zip((1, 3), whole):
        np.testing.assert_array_equal(_port(vols, B, (6, 5, 7), order), want)


def test_nan_matrix_gives_zero_for_order_3_and_no_fault():
    vols = _vols(1, (4, 4, 4), seed=6)
    B = np.full((3, 4), np.nan, np.float32)
    assert (_port(vols, B, (3, 3, 3), 3) == 0).all()
    assert np.isnan(_port(vols, B, (3, 3, 3), 1)).sum() == 0  # every corner invalid: 0


def test_wrapper_rejects_bad_operands_and_counts_no_cpu_launch():
    before = counters["warp_grid.launches"]
    with pytest.raises(ValueError, match="orders 1 and 3"):
        warp.warp_grid(torch.zeros(1, 4, 4, 4), torch.eye(4), (2, 2, 2), 0)
    with pytest.raises(ValueError, match="do not divide"):
        warp.warp_grid(torch.zeros(3, 4, 4, 4), torch.eye(4).repeat(2, 1, 1), (2, 2, 2), 1)
    with pytest.raises(ValueError, match="float32"):
        warp.warp_grid(torch.zeros(1, 4, 4, 4, dtype=torch.float64), torch.eye(4), (2, 2, 2), 1)
    warp.warp_grid(torch.zeros(1, 4, 4, 4), torch.eye(4), (2, 2, 2), 1)
    assert counters["warp_grid.launches"] == before


def _knee_rotation_B():
    """chip_smoke.py phase 8's map: bench.py's rotation (0.07 rad about the
    third world axis, shift (1.2, -0.7, 0.4) mm) on 0.5x0.5x2 mm voxels."""
    from dosma_tpu_torch.ops.registration import _world_matrix_to_index_map

    th = 0.07
    M = np.array([[np.cos(th), -np.sin(th), 0, 1.2], [np.sin(th), np.cos(th), 0, -0.7],
                  [0, 0, 1.0, 0.4], [0, 0, 0, 1.0]], np.float32)
    A = torch.from_numpy(np.diag([0.5, 0.5, 2.0, 1.0]).astype(np.float32))
    return _world_matrix_to_index_map(torch.from_numpy(M), A, A)[:3].numpy()


_KNEE = (384, 384, 160)
# name -> (B, source dims (unpadded), output shape, expected branch)
_BRANCH_CASES = {
    "identity": (np.eye(4, dtype=np.float32)[:3], _KNEE, _KNEE, "staged"),
    "knee_rotation": (_knee_rotation_B(), _KNEE, _KNEE, "staged"),
    "axis_permutation": (np.array([[0, 0, 1, 0.5], [0, 1, 0, 0.25], [1, 0, 0, -1.0]], np.float32),
                         (40, 48, 64), (64, 48, 40), "staged"),
    "zoom_out_3": (_rotation_B(_KNEE, 3.0, (0.4, -0.2, 0.3), 3.0), _KNEE, _KNEE, "mixed"),
    "nan_matrix": (np.full((3, 4), np.nan, np.float32), (20, 20, 20), (17, 19, 33), "gather"),
}


@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("case", sorted(_BRANCH_CASES))
def test_branch_decision(case, order):
    B, dims, out_shape, want = _BRANCH_CASES[case]
    src_shape = tuple(d + 4 for d in dims) if order == 3 else dims
    br = warp.warp_branches(B, src_shape, out_shape, order)
    tiles = int(np.prod([-(-o // t) for o, t in zip(out_shape, warp._TILE[order])]))
    assert br["staged"] + br["gather"] == tiles
    if want == "staged":
        assert br["gather"] == 0 and 0 < br["box_max"] <= warp._BOX_CAP
    elif want == "gather":
        assert br["staged"] == 0
    else:  # tiles inside the volume overflow the buffer; those clipped to a face do not
        assert br["gather"] > 0 and br["staged"] > 0
    if case == "knee_rotation":
        # what the tiles were chosen for: two volumes a buffer, and the read
        # amplification that costs (1.33 and 2.18)
        assert br["volumes_per_buffer"] >= 2
        assert br["read_amplification"] <= (1.35 if order == 1 else 2.2)


def test_branch_decision_per_group():
    Bs = np.stack([np.eye(4, dtype=np.float32)[:3], np.full((3, 4), np.nan, np.float32)])
    br = warp.warp_branches(Bs, (20, 20, 20), (20, 20, 20), 1)
    tiles = int(np.prod([-(-20 // t) for t in warp._TILE[1]]))
    assert br["staged"] == br["gather"] == tiles  # one group each way


@pytest.mark.parametrize("case", ["identity", "rotation_shift", "partly_outside"])
def test_separable_cubic_gather_matches_float64_taps(case):
    """The separable float32 sum (k, then j, then i) against the 64 tap
    products summed in float64."""
    from dosma_tpu_torch.ops import interp

    nb, src_shape, out_shape, B = _PALLAS_CASES[case]
    vols = torch.from_numpy(_vols(1, src_shape, seed=9))
    cp = warp.prepare_sources(vols, 3)[0]
    c = interp._clip_to_domain(warp._grid_coords(torch.from_numpy(B), 0, int(np.prod(out_shape)),
                                                 out_shape), src_shape)
    got = interp._cubic_gather(cp, c).numpy()

    def b3(t):
        at = np.abs(t)
        return np.where(at < 1, (4 - 6 * at ** 2 + 3 * at ** 3) / 6,
                        np.where(at < 2, (2 - at) ** 3 / 6, 0.0))

    cd = c.numpy().astype(np.float64)
    fl = np.floor(cd)
    w = [[b3(cd[ax] - fl[ax] + 1 - a) for a in range(4)] for ax in range(3)]
    base = fl.astype(np.int64) + 1
    cpd = cp.numpy().astype(np.float64)
    want = np.zeros(cd.shape[1])
    for a in range(4):
        for b in range(4):
            for d in range(4):
                want += (w[0][a] * w[1][b] * w[2][d]
                         * cpd[base[0] + a, base[1] + b, base[2] + d])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, float(np.abs(cpd).max())))
