"""The port's sharded entry points (``dosma_tpu_torch/parallel/``) against
``dosma_tpu``'s on its 8-device CPU mesh, at a world of one rank and on
gloo worlds of CPU processes.

Each multi-rank world is spawned once for the module (a module-scoped
fixture runs every scenario and returns the results; the rank functions are
in ``tests/torch_worlds.py``). Tolerances:

- ``sharded_lm_fit``: those of the unsharded parity tests; monoexponential
  |Δ| <= 1e-4, the rest |Δ| <= 2e-5 * max(1, |v|), equal NaN positions,
  r² within 1e-4; a world of 4 ranks equals a world of 1 bit for bit (each
  voxel's fit is its own);
- ``sharded_register_chain_batch`` (JAX's draws injected): matrices within
  1e-3, warped volumes within 1e-4 * max|v| (``tests/
  test_torch_registration.py``); 2 ranks equal 1 rank bit for bit;
- ``sharded_unet_inference``: 1e-5 against JAX's;
- the sharded qDESS flow: ``tests/test_torch_qdess.py``'s map tolerances and
  femoral cartilage's rows at rtol 1e-9; the 2-rank map equals the port's
  unsharded map bit for bit.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import dosma_tpu_torch as dt
from dosma_tpu.parallel import sharding as jsh
from dosma_tpu_torch.parallel import sharding as tsh
from dosma_tpu_torch.parallel.dryrun import QDESS_T2, launch
from tests import torch_worlds as W
from tests.test_torch_tissues import RTOL_F64, assert_frames_match


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU, on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with dt.default_device("cpu"):
            yield
    finally:
        torch.set_num_threads(threads)


def _jmono(xc, p):
    return p[0] * jnp.exp(p[1] * xc)


def _joffset(xc, p):
    return p[0] * jnp.exp(p[1] * xc) + p[2]


def _fit_cases():
    """The JAX package's sharded-fit tests, by name: the port's case
    ``(model, x, Y, p0, kernel, kwargs)`` and the JAX call's arguments."""
    cases = {}
    rs = np.random.RandomState(0)  # test_parallel_and_train.py:93, 1000 voxels
    x = np.array([10.0, 20.0, 30.0, 40.0], np.float32)
    b = -1 / (rs.rand(1000).astype(np.float32) * 70 + 10)
    Y = np.exp(b[:, None] * x[None, :]).astype(np.float32)
    p0 = np.array([1.0, -1 / 30], np.float32)
    cases["mono_1000"] = (("mono_user", x, Y, p0, "auto", {"max_iter": 60}),
                          (_jmono, "auto", 8, {}))

    rs = np.random.RandomState(7)  # :129, 693 voxels under a mask
    shape = (9, 11, 7)
    x = np.array([5.0, 15.0, 30.0, 60.0], np.float32)
    b = -1 / (rs.rand(*shape).astype(np.float32) * 70 + 10)
    vol = np.exp(b[..., None] * x)
    mask = rs.rand(*shape) > 0.45
    Y = vol[mask].astype(np.float32)
    cases["masked_693"] = (("mono_user", x, Y, p0, "auto", {"max_iter": 60}),
                           (_jmono, "auto", 8, {}))

    rs = np.random.RandomState(7)  # :163, the monoexponential kernel
    x = np.array([5.0, 15.0, 30.0, 55.0], np.float32)
    b = -1 / (rs.rand(600).astype(np.float32) * 70 + 10)
    a = 0.5 + rs.rand(600).astype(np.float32)
    Y = (a[:, None] * np.exp(b[:, None] * x[None, :])).astype(np.float32)
    cases["pallas_monoexp"] = (("monoexponential", x, Y, p0, "pallas_monoexp",
                                {"max_iter": 50}), ("monoexponential", "pallas_monoexp", 2, {}))

    rs = np.random.RandomState(11)  # :204, the biexponential kernel
    N = 150
    x = np.linspace(0.0, 10.0, 8).astype(np.float32)
    a1 = 0.8 + 0.4 * rs.rand(N).astype(np.float32)
    b1 = -(0.4 + 0.2 * rs.rand(N).astype(np.float32))
    a2 = 0.3 + 0.3 * rs.rand(N).astype(np.float32)
    b2 = -(0.03 + 0.03 * rs.rand(N).astype(np.float32))
    Y = (a1[:, None] * np.exp(b1[:, None] * x) + a2[:, None] * np.exp(b2[:, None] * x)
         ).astype(np.float32)
    cases["pallas_biexp"] = (("biexponential", x, Y, np.array([1.0, -0.5, 0.4, -0.04],
                                                              np.float32),
                              "pallas_biexp", {"max_iter": 100}),
                             ("biexponential", "pallas_biexp", 2, {}))

    rs = np.random.RandomState(0)  # :468, the generic kernel of a user model
    x = np.array([5.0, 15.0, 30.0, 50.0, 80.0], np.float32)
    a = rs.rand(509).astype(np.float32) + 0.5
    b = -1 / (rs.rand(509).astype(np.float32) * 70 + 10)
    c = rs.rand(509).astype(np.float32) * 0.2
    Y = (a[:, None] * np.exp(b[:, None] * x) + c[:, None]).astype(np.float32)
    cases["pallas_generic"] = (("offset_exp_user", x, Y,
                                np.array([1.0, -1 / 30, 0.0], np.float32), "pallas_generic",
                                {"max_iter": 60}), (_joffset, "pallas_generic", 8,
                                                    {"block_n": 64}))
    return cases


def _jax_fit(port_case, jax_case):
    from dosma_tpu.core import fitting as jfit

    _kind, x, Y, p0, _kernel, kw = port_case
    model, kernel, n_dev, extra = jax_case
    if isinstance(model, str):
        model = getattr(jfit, model)
    mesh = jsh.get_mesh(jax.devices()[:n_dev])
    with pltpu.force_tpu_interpret_mode():
        out = jsh.sharded_lm_fit(model, x, Y, p0, mesh=mesh, kernel=kernel, **kw, **extra)
    return tuple(np.asarray(o) for o in out)


SEG_FEATURES = (8, 16, 32)


@pytest.fixture(scope="module")
def fits():
    """Every fit case: JAX's result, the port's at world 1 and on 4 ranks,
    and sharded inference of 10 slices on 4 ranks."""
    from tests.test_torch_unet2d import random_unet_params

    cases = _fit_cases()
    port_cases = {k: v[0] for k, v in cases.items()}
    with dt.default_device("cpu"):
        world1 = W.run_fits(port_cases)
    seg_params = random_unet_params(seed=0, num_classes=2, features=SEG_FEATURES)
    slices = np.random.RandomState(2).rand(10, 32, 32, 1).astype(np.float32)
    world4 = launch(W.fits_and_inference, 4, "gloo", (port_cases, seg_params, slices))
    jax_out = {k: _jax_fit(*v) for k, v in cases.items()}
    return {"jax": jax_out, "world1": world1, "world4": world4, "seg_params": seg_params,
            "slices": slices}


def _check_fit(name, got, ref):
    (pt, rt, ct), (pj, rj, cj) = got, ref
    assert pt.shape == pj.shape and rt.shape == rj.shape and ct.shape == cj.shape
    np.testing.assert_array_equal(np.isnan(pt), np.isnan(pj))
    fin = np.isfinite(pj)
    err = np.abs(pt - pj)[fin]
    if name == "pallas_monoexp":
        assert err.max(initial=0.0) <= 1e-4, name
    else:
        assert (err <= 2e-5 * np.maximum(1.0, np.abs(pj[fin]))).all(), (name, err.max())
    assert np.abs(rt - rj).max() <= 1e-4
    assert (ct == cj).mean() >= 0.99


@pytest.mark.parametrize("name", list(_fit_cases()))
def test_sharded_fit_at_world_one_matches_jax(fits, name):
    got = fits["world1"][name]
    assert all(isinstance(o, np.ndarray) for o in got)
    _check_fit(name, got, fits["jax"][name])


@pytest.mark.parametrize("name", list(_fit_cases()))
def test_sharded_fit_on_four_ranks_equals_world_one(fits, name):
    for rank, (fit_out, _seg) in enumerate(fits["world4"]):
        for a, b in zip(fit_out[name], fits["world1"][name]):
            np.testing.assert_array_equal(a, b, err_msg=f"{name}, rank {rank}")
    _check_fit(name, fits["world4"][0][0][name], fits["jax"][name])


def test_sharded_fit_kernel_names():
    x = np.array([1.0, 2.0, 3.0], np.float32)
    Y = np.exp(-np.outer(np.linspace(0.1, 0.5, 5), x)).astype(np.float32)
    with pytest.raises(ValueError, match="Unknown kernel"):
        tsh.sharded_lm_fit(W.mono_user, x, Y, np.array([1.0, -0.1]), kernel="pallas")
    # "auto" with the library monoexponential on the CPU: its plain version.
    from dosma_tpu_torch.ops import monoexp

    launches = monoexp.monoexp_lm.launches
    popt, _, conv = tsh.sharded_lm_fit(dt.monoexponential, x, Y, np.array([1.0, -0.1]),
                                       max_iter=50)
    assert monoexp.monoexp_lm.launches == launches and conv.all()
    np.testing.assert_allclose(popt[:, 1], -np.linspace(0.1, 0.5, 5), rtol=1e-4)
    # Per-voxel p0 is split like y; a tensor y gives tensors on its device.
    p0 = np.tile(np.array([1.0, -0.2], np.float32), (5, 1))
    popt_t, _, _ = tsh.sharded_lm_fit(W.mono_user, x, torch.from_numpy(Y), p0, max_iter=50)
    assert isinstance(popt_t, torch.Tensor)
    np.testing.assert_allclose(popt_t.numpy()[:, 1], -np.linspace(0.1, 0.5, 5), rtol=1e-4)


def test_sharded_fit_refused_model_warns_and_takes_lm_fit():
    def clipped(x_col, params):
        return params[0] * torch.exp(torch.clamp(params[1] * x_col, max=0.0))

    x = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    Y = np.exp(-np.outer(np.linspace(0.1, 0.5, 6), x)).astype(np.float32)
    with pytest.warns(UserWarning, match="lm_fit"):
        popt, _, conv = tsh.sharded_lm_fit(clipped, x, Y, np.array([1.0, -0.2], np.float32),
                                           max_iter=60)
    assert conv.all()
    np.testing.assert_allclose(popt[:, 1], -np.linspace(0.1, 0.5, 6), rtol=1e-4)


@pytest.mark.parametrize("n,world", [(10, 8), (16, 8), (5, 2), (1000, 8)])
def test_shard_voxels_pad_counts_match_jax(n, world):
    arr = np.random.RandomState(n).rand(n, 4).astype(np.float32)
    jarr, jpad = jsh.shard_voxels(arr, jsh.get_mesh(jax.devices()[:world]))
    mesh = tsh.Mesh((world,), ("data",))  # rank 0's view of a world of `world` ranks
    block, pad = tsh.shard_voxels(arr, mesh)
    assert pad == jpad
    assert block.shape[0] * world == jarr.shape[0]
    np.testing.assert_array_equal(block.numpy(), np.asarray(jarr)[:block.shape[0]])


def test_get_mesh_without_a_process_group():
    mesh = tsh.get_mesh()
    assert mesh.device_mesh is None and mesh.size == 1 and mesh.axis_rank("data") == 0
    assert mesh.group("data") is None and mesh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="process group"):
        tsh.make_mesh((2, 1), ("data", "model"))
    sh = tsh.NamedSharding(mesh, tsh.PartitionSpec(None, "data"))
    t = sh.place(np.arange(12.0).reshape(3, 4))
    assert isinstance(t, torch.Tensor) and tuple(t.shape) == (3, 4)
    with pytest.raises(ValueError, match="not an axis"):
        tsh.NamedSharding(mesh, tsh.PartitionSpec("model"))


def test_sharded_inference_on_four_ranks_matches_jax(fits):
    from dosma_tpu.models.unet2d import unet2d_forward

    params, v = fits["seg_params"], fits["slices"]
    want = np.asarray(jax.jit(unet2d_forward)(params, jnp.asarray(v)))
    model = type("ParamsOnly", (), {"params": params})()
    for got in [tsh.sharded_unet_inference(model, v)] + [s for _f, s in fits["world4"]]:
        assert got.shape == want.shape == (10, 32, 32, 2)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ----------------------------------------------------------------------
# Registration and the qDESS flow on 2 ranks
# ----------------------------------------------------------------------
_REG_CFGS = [dict(transform="translation", metric="mse", resolutions=2, iterations=120,
                  num_samples=2048, learning_rate=0.05)]
_SHIFTS = [(2, -1, 0), (-2, 2, 1), (3, 0, -1), (0, -3, 1)]
_N_SL = 5  # slices of the qDESS series: 2 ranks do not divide it


def _reg_inputs():
    rs = np.random.RandomState(0)  # test_parallel_and_train.py:420
    fixed = np.zeros((32, 32, 8), np.float32)
    fixed[8:-8, 8:-8, 2:-2] = 1.0
    fixed += 0.05 * rs.rand(32, 32, 8).astype(np.float32)
    movings = np.stack([np.roll(fixed, s, axis=(0, 1, 2)) for s in _SHIFTS])
    return fixed, movings


def _recording_jax_draws(table):
    def draws(seed, level, iterations, num_samples, device):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), level)
        u = np.array(jax.random.uniform(key, (iterations, 3, num_samples)))
        table[(int(seed), int(level), int(iterations), int(num_samples))] = u
        return torch.from_numpy(u).to(device)

    return draws


def _arc(n_sl):
    from dosma_tpu_torch.parallel.dryrun import condyle_annulus

    return condyle_annulus((32, 32, n_sl))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """JAX's sharded registration and qDESS twin, the port's at world 1
    (JAX's draws injected and recorded), and both on 2 ranks."""
    from dosma_tpu.core.io.dicom.dataset import Tag as JTag
    from dosma_tpu.ops.registration import RegistrationParams as JParams
    from dosma_tpu_torch.ops import registration as treg
    from tests.util import write_dicom_series

    fixed, movings = _reg_inputs()
    table = {}
    real = treg._level_draws
    treg._level_draws = _recording_jax_draws(table)
    try:
        with dt.default_device("cpu"):
            world1_reg = tsh.sharded_register_chain_batch(
                fixed, np.eye(4), movings, np.eye(4),
                [dt.RegistrationParams(**c) for c in _REG_CFGS])
    finally:
        treg._level_draws = real
    jax_reg = jsh.sharded_register_chain_batch(
        fixed, np.eye(4), movings, np.eye(4), [JParams(**c) for c in _REG_CFGS],
        mesh=jsh.get_mesh())

    series = str(tmp_path_factory.mktemp("qdess_series") / "qdess")
    write_dicom_series(series, shape=(32, 32, _N_SL), n_echos=2, plane="sagittal",
                       extra={JTag(0x0019, 0x10B6): 3132.0, JTag(0x0019, 0x10B7): 1560.0})
    ranks = launch(W.registration_and_qdess, 2, "gloo",
                   (table, fixed, movings, _REG_CFGS, series, _arc(_N_SL), QDESS_T2,
                    str(tmp_path_factory.mktemp("dryrun"))))
    return {"world1_reg": world1_reg, "jax_reg": jax_reg, "ranks": [r[:-1] for r in ranks],
            "devices": [r[-1] for r in ranks], "series": series}


def test_sharded_registration_on_two_ranks_matches_jax(two_ranks):
    Ms_j, warped_j = two_ranks["jax_reg"]
    Ms_1, warped_1 = two_ranks["world1_reg"]
    assert Ms_1.shape == (4, 1, 4, 4) and Ms_1.dtype == np.float64
    np.testing.assert_allclose(Ms_1, np.asarray(Ms_j), rtol=0, atol=1e-3)
    # The warps against JAX's under the same maps (the port's).
    from dosma_tpu.ops.registration import warp_volume

    fixed, movings = _reg_inputs()
    order = dt.RegistrationParams(**_REG_CFGS[0]).final_interp_order
    for i in range(len(_SHIFTS)):
        ref = np.asarray(warp_volume(movings[i], Ms_1[i, -1], np.eye(4), np.eye(4), fixed.shape,
                                     order=order))
        assert np.abs(warped_1[i] - ref).max() <= 1e-4 * np.abs(ref).max()
    assert np.asarray(warped_j).shape == warped_1.shape
    for M, s in zip(Ms_1[:, 0], _SHIFTS):
        np.testing.assert_allclose(M[:3, 3], s, atol=0.5)
    for rank, (reg, *_rest) in enumerate(two_ranks["ranks"]):
        np.testing.assert_array_equal(reg[0], Ms_1, err_msg=f"rank {rank}")
        np.testing.assert_array_equal(reg[1], warped_1, err_msg=f"rank {rank}")


def test_a_rank_computes_on_the_cpu_only_when_asked(two_ranks):
    """Under a gloo group a rank follows the input and the default device,
    not the backend: host data and CPU tensors stay on the CPU the rank
    asked for, and with the first card as the default device again the
    sharded fit of host data raises on a machine without one."""
    for rank, got in enumerate(two_ranks["devices"]):
        assert got["host"] == "cpu" and got["cpu_tensor"] == "cpu", (rank, got)
        assert "no CUDA device is available" in got["card_default"], (rank, got)


def test_sharded_registration_takes_matrix_stages_only():
    fixed, movings = _reg_inputs()
    with pytest.raises(ValueError, match="matrix stages only"):
        tsh.sharded_register_chain_batch(
            fixed, np.eye(4), movings[:2], np.eye(4),
            [dt.RegistrationParams(transform="bspline", metric="mse")])


def _jax_qdess_twin(series):
    """``test_parallel_and_train.py``'s CI twin on 2 JAX devices: the T2 map
    (padded slices dropped) and femoral cartilage's rows."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from dosma_tpu.core.med_volume import MedicalVolume
    from dosma_tpu.scan_sequences.mri.qdess import QDess
    from dosma_tpu.tissues.femoral_cartilage import FemoralCartilage

    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    scan = QDess.from_dicom(series, group_by="EchoNumbers")
    pad = (-_N_SL) % 2
    sh = NamedSharding(mesh, P(None, None, "data"))
    echoes = [MedicalVolume(jax.device_put(jnp.asarray(np.pad(
        np.asarray(v.volume, np.float32), ((0, 0), (0, 0), (0, pad)), mode="edge")), sh),
        v.affine) for v in scan.volumes]
    t2 = QDess(echoes).generate_t2_map(**QDESS_T2)
    t2_map = np.asarray(t2.volumetric_map.volume)[..., :_N_SL]  # rows reformat it in place
    raw = QDess(echoes).generate_t2_map(**{**QDESS_T2, "decimals": None, "nan_bounds": None,
                                           "nan_to_num": None})
    mask = np.pad(_arc(_N_SL), ((0, 0), (0, 0), (0, pad)))
    fc = FemoralCartilage(medial_to_lateral=True)
    fc.set_mask(MedicalVolume(mask, scan.volumes[0].affine), use_largest_cc=False,
                split_regions=True)
    fc.add_quantitative_value(t2)
    fc.calc_quant_vals()
    return t2_map, np.asarray(raw.volumetric_map.volume)[..., :_N_SL], fc.quant_vals["T2"][1]


def test_sharded_qdess_flow_on_two_ranks_matches_jax(two_ranks):
    want, raw, want_df = _jax_qdess_twin(two_ranks["series"])
    scan = dt.QDess.from_dicom(two_ranks["series"])
    unsharded = scan.generate_t2_map(**QDESS_T2).volumetric_map.volume
    sizes = []
    for rank, (_reg, placements, local_shape, whole, (header, rows), _d) in \
            enumerate(two_ranks["ranks"]):
        assert placements == [("Shard", 2)], placements
        sizes.append(local_shape[2])
        np.testing.assert_array_equal(whole, unsharded, err_msg=f"rank {rank}")
        near = np.abs(raw.astype(np.float64) * 10 % 1 - 0.5) <= 1e-3
        np.testing.assert_array_equal(whole[~near], want[~near])
        assert np.all(np.abs(whole[near] - want[near]) <= 0.1 + 1e-5)
        assert len(rows) == 18
        assert_frames_match(pd.DataFrame(rows, columns=header), want_df, RTOL_F64)
    assert sizes == [3, 2]  # torch.chunk's split of 5 slices


# ----------------------------------------------------------------------
# Placement of volumes at world 1, and the dry run
# ----------------------------------------------------------------------
def test_device_put_without_a_group_and_with_a_device(tmp_path):
    vol = dt.MedicalVolume(np.arange(24, dtype=np.uint16).reshape(2, 3, 4), np.eye(4))
    sh = tsh.NamedSharding(tsh.get_mesh(), tsh.PartitionSpec(None, None, "data"))
    placed = vol.device_put(sharding=sh)
    assert isinstance(placed.A, torch.Tensor) and placed.A.dtype == torch.int32
    np.testing.assert_array_equal(placed.A.numpy(), vol.A.astype(np.int32))
    on_cpu = vol.device_put("cpu")
    assert isinstance(on_cpu.A, torch.Tensor) and on_cpu.device == dt.cpu_device
    assert vol.device_put().device == dt.cpu_device  # the default device, as asked


def test_dryrun_flows_on_two_ranks(two_ranks):
    """``python -m dosma_tpu_torch.parallel.dryrun --ranks 2 --backend gloo``
    runs these flows on its world and prints rank 0's line."""
    from dosma_tpu_torch.parallel.dryrun import summary_line

    line = summary_line(two_ranks["ranks"][0][-1])
    assert line.startswith("dryrun_multichip OK: mesh={'data': 1, 'model': 2}"), line
    assert "DICOM(5 uneven slices)->T2 over 2 ranks (host-parity OK)->18 metric rows" in line
    assert two_ranks["ranks"][1][-1]["loss"] == two_ranks["ranks"][0][-1]["loss"]


def test_dryrun_command_line(monkeypatch, capsys):
    from dosma_tpu_torch.parallel import dryrun

    calls = []
    monkeypatch.setattr(dryrun, "launch", lambda fn, ranks, backend, args, timeout:
                        calls.append((fn, ranks, backend)) or [dict(
                            mesh={"data": 2, "model": 2}, loss=1.0, conv=1.0, seg_slices=7,
                            n_sl=7, t2_ranks=4, rows=18, reg_err=0.0)] * ranks)
    assert dryrun.main(["--ranks", "4", "--backend", "gloo"]) == 0
    assert calls == [(dryrun.flows, 4, "gloo")]
    assert capsys.readouterr().out.startswith("dryrun_multichip OK: mesh={'data': 2")
