"""The port's command line (``dosma_tpu_torch.cli``) against ``dosma_tpu``'s,
on the same DICOM series, at small sizes on the CPU (mirrors
``tests/test_cli.py``).

Tolerances: the qDESS T2 maps are rounded to 0.1 by both packages; off a
rounding boundary they agree within one float32 ulp, and where the unrounded
value lies within 1e-3 of a boundary within 0.1 + one ulp (``ops/qmri``'s
float32 arithmetic differs by an ulp between XLA and torch).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import dosma_tpu
import dosma_tpu_torch as dt
from dosma_tpu import cli as jcli
from dosma_tpu.core.io.dicom import Tag
from dosma_tpu_torch import cli
from tests.util import write_dicom_series

_REPO = Path(__file__).resolve().parent.parent

QDESS_TAGS = {Tag(0x0019, 0x10B6): 3132.0, Tag(0x0019, 0x10B7): 1560.0,
              "RepetitionTime": 25.0, "FlipAngle": 30.0}


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU."""
    from dosma_tpu_torch.core.device import default_device

    with default_device("cpu"):
        yield


@pytest.fixture
def qdess_series(tmp_path):
    src = tmp_path / "dicoms"
    write_dicom_series(str(src), shape=(32, 32, 4), n_echos=2, echo_times=[8.0, 42.0],
                       extra=QDESS_TAGS)
    return src


def _load(path):
    return dt.NiftiReader().load(str(path))


def _parser_tree(parser):
    """Every argument of a parser and of its subparsers, without help texts
    and the program's name."""
    import argparse

    out = []
    for a in parser._actions:
        if isinstance(a, argparse._SubParsersAction):
            out.append(("sub", a.dest, {name: _parser_tree(p) for name, p in a.choices.items()}))
        elif not isinstance(a, argparse._HelpAction):
            default = a.default if a.dest != "pid" else None  # a fresh uuid each parser
            out.append((tuple(a.option_strings), a.dest, a.nargs, default, a.required,
                        tuple(a.choices) if a.choices else None, type(a).__name__))
    return out


class TestCmdLineDeclarations:
    def test_every_scan_has_the_jax_packages_actions(self):
        assert [s.NAME for s in cli.SUPPORTED_SCAN_TYPES] == [
            s.NAME for s in jcli.SUPPORTED_SCAN_TYPES]
        for scan, jscan in zip(cli.SUPPORTED_SCAN_TYPES, jcli.SUPPORTED_SCAN_TYPES):
            actions = scan.cmd_line_actions()
            assert len(actions) > 0, scan.NAME
            for (method, wrapper), (_, jwrapper) in zip(actions, jscan.cmd_line_actions(),
                                                        strict=True):
                assert wrapper.name == method.__name__ == jwrapper.name
                assert isinstance(wrapper.help, str) and wrapper.help == jwrapper.help
                assert list(wrapper.aliases) == list(jwrapper.aliases)

    def test_parser_equals_the_jax_packages(self):
        (parser, flags), (jparser, jflags) = cli._build_parser(), jcli._build_parser()
        assert sorted(flags) == sorted(jflags)
        assert _parser_tree(parser) == _parser_tree(jparser)

    def test_help_does_not_crash(self, capsys):
        with pytest.raises(SystemExit) as e:
            cli.parse_args(["--help"])
        assert e.value.code == 0
        assert "qdess" in capsys.readouterr().out

    def test_requires_input_path(self):
        with pytest.raises(ValueError, match="Must provide"):
            cli.parse_args(["qdess"])

    def test_missing_dicom_directory_raises(self, tmp_path):
        with pytest.raises(NotADirectoryError):
            cli.parse_args(["--d", str(tmp_path / "absent"), "--s", str(tmp_path / "out"),
                            "qdess"])


class TestQDessCommandLine:
    def test_t2_map_equals_the_jax_clis(self, tmp_path, qdess_series):
        save_t, save_j = tmp_path / "out_t", tmp_path / "out_j"
        cmd = "--d {} --s {} qdess --fc generate_t2_map --t1 1200"
        cli.parse_args(cmd.format(qdess_series, save_t).split())
        jcli.parse_args(cmd.format(qdess_series, save_j).split())
        assert (save_t / "qdess" / "qdess.data").is_file()
        got = _load(save_t / "fc" / "t2" / "t2.nii.gz")
        want = dosma_tpu.NiftiReader().load(str(save_j / "fc" / "t2" / "t2.nii.gz"))
        np.testing.assert_array_equal(got.affine, want.affine)
        a, b = got.A, np.asarray(want.A)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (32, 32, 4)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        raw = np.asarray(dosma_tpu.QDess.from_dicom(str(qdess_series)).generate_t2_map(
            t1=1200.0, decimals=None, nan_bounds=None, nan_to_num=None).volumetric_map.A)
        scaled = raw.astype(np.float64) * 10
        near = np.abs(scaled - np.floor(scaled) - 0.5) <= 1e-3
        ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
        fin = ~np.isnan(a)
        assert (np.abs(a - b)[fin & ~near] <= ulp[fin & ~near]).all()
        assert (np.abs(a - b)[fin & near] <= 0.1 + ulp[fin & near]).all()

    def test_load_after_save(self, tmp_path, qdess_series):
        save = tmp_path / "out"
        cli.parse_args(f"--d {qdess_series} --s {save} qdess".split())
        cli.parse_args(f"--l {save} qdess".split())
        loaded = dt.QDess.load(str(save / "qdess"))
        direct = dt.QDess.from_dicom(str(qdess_series))
        for v, w in zip(loaded.volumes, direct.volumes, strict=True):
            np.testing.assert_array_equal(np.asarray(v.A), np.asarray(w.A))
            np.testing.assert_array_equal(v.affine, w.affine)

    def test_device_load_flag(self, tmp_path, qdess_series):
        """``--device_load`` reads through the pinned prefetch onto the
        default device (the CPU here) and saves the same volumes."""
        plain, pref = tmp_path / "plain", tmp_path / "prefetch"
        cli.parse_args(["--dicom", str(qdess_series), "--save", str(plain), "qdess"])
        cli.parse_args(["--dicom", str(qdess_series), "--save", str(pref), "--device_load",
                        "qdess"])
        for name in ("echo-000.nii.gz", "echo-001.nii.gz"):
            a = _load(plain / "qdess" / "volumes" / name)
            b = _load(pref / "qdess" / "volumes" / name)
            np.testing.assert_array_equal(np.asarray(a.A), np.asarray(b.A))

    def test_gpu_flag_sets_cuda_visible_devices(self, tmp_path, qdess_series, monkeypatch):
        # set, then removed: the teardown restores the variable as it was
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
        cli.parse_args(["--gpu", "0", "--d", str(qdess_series), "--s", str(tmp_path / "o"),
                        "qdess"])
        assert os.environ["CUDA_VISIBLE_DEVICES"] == "0"

    def test_no_card_no_fallback(self, tmp_path, qdess_series):
        """As a user runs it, with no visible card, an action exits non-zero
        with the device error and writes no map: it never computes on the
        CPU in the card's place."""
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        save = tmp_path / "out"
        cli.parse_args(f"--d {qdess_series} --s {save} qdess".split())
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="", HOME=str(tmp_path))
        proc = subprocess.run(
            [sys.executable, "-m", "dosma_tpu_torch.cli", "--l", str(save), "qdess", "--fc",
             "t2"], cwd=_REPO, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert "no CUDA device is available" in proc.stderr
        assert not (save / "fc" / "t2").exists()


def test_tuple_parameter_comma_string():
    from typing import Tuple

    for val, typ in (("0,100", tuple), ("0.5,99.5", Tuple[float, float]), (["1", "2"], tuple),
                     ("3", int), (["4"], int), ("x", str), (None, tuple), (["7"], float)):
        assert cli.parse_basic_type(val, typ) == jcli.parse_basic_type(val, typ)
    assert cli.parse_basic_type("0,100", tuple) == (0, 100)


def test_find_weights_matches_pt_files(tmp_path):
    fc = dt.FemoralCartilage()
    (tmp_path / "iwoai_fc_weights.pth").write_bytes(b"x")
    with pytest.raises(ValueError, match="No file found"):
        fc.find_weights(str(tmp_path))
    pt = tmp_path / "iwoai_fc_weights.pt"
    pt.write_bytes(b"x")
    assert fc.find_weights(str(tmp_path)) == str(pt)
    (tmp_path / "iwoai_fc_weights.h5").write_bytes(b"x")
    with pytest.raises(ValueError, match="multiple weights files"):
        fc.find_weights(str(tmp_path))


# ----------------------------------------------------------------------
# Segmentation through the command line, with .pt and .h5 weights
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def unet_params():
    import jax

    from dosma_tpu.models.unet2d import init_unet2d_params

    return init_unet2d_params(jax.random.PRNGKey(0), num_classes=4)


def test_qdess_segment_end_to_end_with_pt_and_h5_weights(tmp_path, unet_params):
    """``segment`` finds each tissue's weight file (one file for all four
    tissues: one group), builds the model, writes every mask; the ``.pt``
    state dict and the Keras ``.h5`` file of the same weights give the same
    masks."""
    from dosma_tpu.models.weights import save_keras_unet2d_weights
    from dosma_tpu_torch.models.weights import state_dict_from_params

    src = tmp_path / "dicoms"
    write_dicom_series(str(src), shape=(96, 96, 4), n_echos=2, plane="sagittal",
                       extra=QDESS_TAGS)
    name = "iwoai-2019-unet2d_fc-tc-pc-men_weights"
    (tmp_path / "w_pt").mkdir()
    (tmp_path / "w_h5").mkdir()
    torch.save(state_dict_from_params(unet_params), str(tmp_path / "w_pt" / f"{name}.pt"))
    save_keras_unet2d_weights(str(tmp_path / "w_h5" / f"{name}.h5"), unet_params)
    masks = {}
    for kind in ("pt", "h5"):
        save = tmp_path / f"out_{kind}"
        cli.parse_args(f"--d {src} --s {save} qdess --fc --tc --pc --men segment "
                       f"--weights_dir {tmp_path / f'w_{kind}'} --model iwoai-2019-t6 "
                       f"--rss".split())
        masks[kind] = {t: _load(save / t / f"{t}.nii.gz") for t in ("fc", "tc", "pc", "men")}
    for t, m in masks["pt"].items():
        assert m.shape == (96, 96, 4)
        np.testing.assert_array_equal(m.A, masks["h5"][t].A)
        np.testing.assert_array_equal(m.affine, masks["h5"][t].affine)


# ----------------------------------------------------------------------
# CubeQuant through the command line: register, fit, knee
# ----------------------------------------------------------------------
@pytest.fixture
def one_thread():
    """Many small ops: torch's threads cost more than they give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _condyle_arc(shape):
    """The inferior arc of a femoral condyle in each sagittal slice
    (``bench.py``'s recipe), the geometry the femoral analytics expect."""
    h, w, d = shape
    yv, xv = np.mgrid[0:h, 0:w]
    rad = np.sqrt((yv - h * 0.45) ** 2 + (xv - w * 0.5) ** 2)
    annulus = (rad > h * 0.3 * 0.8) & (rad < h * 0.3 * 1.05) & (yv > h * 0.45)
    return np.repeat(annulus[..., None], d, axis=2).astype(np.uint8)


def test_cubequant_register_fit_and_knee(tmp_path, monkeypatch, one_thread):
    """A small CubeQuant series (32x32x8 x 4 spin locks, each rolled by a
    voxel more) through ``intraregister``, ``interregister`` (to spin lock 1
    rolled, with a mask), ``t1_rho`` and ``knee``: the transform files are
    written, the saved T1ρ map equals ``generate_t1_rho_map`` on the loaded
    registered volumes, and the knee's table holds fc's rows of that map."""
    from dosma_tpu_torch.core.io.dicom_io import to_RAS_affine
    from dosma_tpu_torch.parallel.dryrun import series_headers

    monkeypatch.setenv("DOSMA_TEMP_DIR", str(tmp_path / "temp"))
    shape, times = (32, 32, 8), (1.0, 10.0, 30.0, 60.0)
    rs = np.random.RandomState(3)
    relax = rs.rand(*shape).astype(np.float32) * 80 + 20
    zz, yy, xx = np.meshgrid(*(np.linspace(-1, 1, n) for n in shape), indexing="ij")
    base = 1000.0 * np.exp(-(zz ** 2 + yy ** 2) / 0.3 - xx ** 2 / 0.8) + 50.0
    pixels = np.stack([np.rint(np.roll(base * np.exp(-t / relax), (i, -i, 0), axis=(0, 1, 2)))
                       .astype(np.uint16) for i, t in enumerate(times)], axis=-1)
    headers = series_headers(shape, (0.5, 0.5, 1.0), times)
    affine = to_RAS_affine(list(headers[0, 0, :, 0]))
    src, save = tmp_path / "series", tmp_path / "out"
    dt.DicomWriter().save(dt.MedicalVolume(pixels, affine, headers=headers), str(src))
    target, mask = tmp_path / "target.nii.gz", tmp_path / "mask.nii.gz"
    dt.MedicalVolume(np.roll(pixels[..., 0].astype(np.float32), (1, -1, 0), axis=(0, 1, 2)),
                     affine).save_volume(str(target))
    box = np.zeros(shape, np.uint8)
    box[8:24, 8:24, 2:6] = 1
    dt.MedicalVolume(box, affine).save_volume(str(mask))

    cli.parse_args(f"--d {src} --s {save} cubequant intraregister".split())
    cli.parse_args(f"--l {save} cubequant interregister --tp {target} --tm {mask}".split())
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "temp")
                   for d, _, fs in os.walk(tmp_path / "temp") for f in fs
                   if f.startswith("TransformParameters."))
    # one affine stage for each of the 3 moving spin locks; rigid + affine to the target
    assert sorted(f.split(os.sep)[-3:] for f in files) == (
        [["interregistered", "moving-0", f"TransformParameters.{i}.json"] for i in (0, 1)]
        + [["intraregister", f"moving-{k}", "TransformParameters.0.json"] for k in range(3)])
    registered = dt.CubeQuant.load(str(save / "cubequant"))
    cli.parse_args(f"--l {save} cubequant --fc t1_rho --mask_path {mask}".split())
    got = _load(save / "fc" / "t1_rho" / "t1_rho.nii.gz")
    fc = dt.FemoralCartilage()
    want = registered.generate_t1_rho_map(tissue=fc, mask_path=str(mask)).volumetric_map
    np.testing.assert_array_equal(got.A, np.asarray(want.A))
    assert np.isfinite(got.A).all() and (got.A[box.astype(bool)] > 0).mean() > 0.9

    # knee reads fc's mask from its directory, as a segment call leaves it.
    dt.MedicalVolume(_condyle_arc(shape), affine).save_volume(str(save / "fc" / "fc.nii.gz"))
    cli.parse_args(f"--l {save} knee --fc --t1_rho --pid P7".split())
    from dosma_tpu_torch.utils.io_utils import load_tables

    header, rows = load_tables(str(save / "fc" / "data.xlsx"))["T1_RHO"]
    fc = dt.FemoralCartilage()
    fc.pid = "P7"
    fc.load_data(str(save))
    qv = fc.quantitative_values[0]
    want_header, want_rows, _ = fc.quant_rows(qv.volumetric_map, qv.qv_type)
    assert header == want_header and len(rows) == len(want_rows) > 0
    for r, w in zip(rows, want_rows):
        assert len(r) == len(w)
        for a, b in zip(r, w):
            if b is None or isinstance(b, str):
                assert a == b
            else:
                np.testing.assert_allclose(a, b, rtol=1e-12)


def test_qdess_flow_without_optional_packages(tmp_path, unet_params):
    """The machine with the card has no matplotlib, pandas, yaml or h5py:
    the documented qDESS calls (segment with ``.pt`` weights, t2, knee) run
    with each of them unimportable, write the masks, maps and tables, and
    only skip the figures."""
    from dosma_tpu_torch.models.weights import state_dict_from_params

    src, save, weights = tmp_path / "dicoms", tmp_path / "out", tmp_path / "weights"
    write_dicom_series(str(src), shape=(96, 96, 4), n_echos=2, plane="sagittal",
                       echo_times=[8.0, 42.0], extra=QDESS_TAGS)
    weights.mkdir()
    torch.save(state_dict_from_params(unet_params),
               str(weights / "iwoai-2019-unet2d_fc-tc-pc-men_weights.pt"))
    np.save(str(tmp_path / "arc.npy"), _condyle_arc((96, 96, 4)))
    code = (
        "import sys, warnings\n"
        "for m in ('matplotlib', 'pandas', 'yaml', 'h5py', 'jax', 'dosma_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, dosma_tpu_torch as dt\n"
        "from dosma_tpu_torch.cli import parse_args\n"
        "dt.set_default_device('cpu')\n"
        f"src, save, w = {str(src)!r}, {str(save)!r}, {str(weights)!r}\n"
        "parse_args(f'--d {src} --s {save} qdess --fc segment --weights_dir {w} "
        "--model iwoai-2019-t6 --rss'.split())\n"
        "m = dt.NiftiReader().load(f'{save}/fc/fc.nii.gz')\n"
        f"arc = np.load({str(tmp_path / 'arc.npy')!r})\n"
        "dt.MedicalVolume(arc, m.affine).save_volume(f'{save}/fc/fc.nii.gz')\n"
        "parse_args(f'--l {save} qdess --fc t2'.split())\n"
        "with warnings.catch_warnings(record=True) as caught:\n"
        "    warnings.simplefilter('always')\n"
        "    parse_args(f'--l {save} knee --fc --t2'.split())\n"
        "print(sorted({str(c.message).split(':')[0] for c in caught}))\n"
        "print(sorted(m for m, mod in sys.modules.items() if mod is not None and "
        "m.split('.')[0] in ('matplotlib', 'pandas', 'yaml', 'h5py', 'jax', 'dosma_tpu')))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, capture_output=True,
                          text=True, timeout=600, env=dict(os.environ, HOME=str(tmp_path)))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-2:] == ["['matplotlib is not installed']", "[]"]
    from dosma_tpu_torch.utils.io_utils import load_tables

    header, rows = load_tables(str(save / "fc" / "data.xlsx"))["T2"]
    assert len(rows) > 0 and "Mean" in header
    assert (save / "fc" / "t2" / "t2.nii.gz").is_file()
