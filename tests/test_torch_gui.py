"""The port's GUI modules against ``dosma_tpu``'s, headless (mirrors
``tests/gui/test_gui_forms.py`` and ``tests/test_gui_import.py``): form
reflection, command strings, the dialog reader, the console logger, the
overlay math and the error surface. Building windows needs a display and
skips without one, as for the JAX package.
"""

import logging
import os

import numpy as np
import pytest
import torch

import dosma_tpu_torch as dt
from dosma_tpu.gui.gui_utils import forms as jforms
from dosma_tpu.gui.im_viewer import label2rgb as jlabel2rgb
from dosma_tpu_torch.gui.gui_utils import forms
from dosma_tpu_torch.gui.gui_utils.console_output import WidgetLogger
from dosma_tpu_torch.gui.gui_utils.filedialog_reader import FileDialogReader
from dosma_tpu_torch.gui.im_viewer import ImageViewer, label2rgb


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU."""
    from dosma_tpu_torch.core.device import default_device

    with default_device("cpu"):
        yield


def test_gui_modules_import():
    import dosma_tpu_torch.app  # noqa: F401
    import dosma_tpu_torch.gui.dosma_gui  # noqa: F401
    import dosma_tpu_torch.gui.gui_utils.widgets  # noqa: F401
    import dosma_tpu_torch.gui.ims  # noqa: F401
    import dosma_tpu_torch.gui.preferences_viewer  # noqa: F401


# ----------------------------------------------------------------------
# forms
# ----------------------------------------------------------------------
def _scan_actions():
    from dosma_tpu_torch.cli import SUPPORTED_SCAN_TYPES

    return [(scan, w.name) for scan in SUPPORTED_SCAN_TYPES for _, w in scan.cmd_line_actions()]


@pytest.mark.parametrize("scan,action", _scan_actions(), ids=lambda v: getattr(v, "NAME", v))
def test_field_specs_equal_the_jax_packages(scan, action):
    from dosma_tpu import cli as jcli

    jscan = next(s for s in jcli.SUPPORTED_SCAN_TYPES if s.NAME == scan.NAME)
    w, fields = forms.action_fields(scan, action)
    jw, jfields = jforms.action_fields(jscan, action)
    assert w.name == jw.name == action
    assert [vars(f) for f in fields] == [vars(f) for f in jfields]
    for f in fields:
        assert f.kind in ("str", "bool", "int", "float", "list", "filepath", "choice")


def test_segment_action_expands_segmodel():
    _, fields = forms.action_fields(dt.QDess, "segment")
    names = [f.name for f in fields]
    assert "weights_dir" in names and "model" in names and "batch_size" in names
    assert "tissue" not in names
    model_field = next(f for f in fields if f.name == "model")
    assert model_field.kind == "choice" and "iwoai-2019-t6" in model_field.choices
    assert [vars(f) for f in forms.segmentation_fields()] == [
        vars(f) for f in jforms.segmentation_fields()]


def test_filepath_heuristic():
    for name, ptype in (("mask_path", str), ("weights_dir", str), ("output_directory", str),
                        ("beta", str), ("mask_path", int)):
        assert forms.is_filepath_param(name, ptype) == jforms.is_filepath_param(name, ptype)
    assert forms.is_filepath_param("mask_path") and not forms.is_filepath_param("beta")


def test_parse_value_matches_jax():
    cases = [("3", "int"), ("2.5", "float"), ("yes", "bool"), ("false", "bool"),
             ("[1, 2]", "list"), ("abc", "str"), ("", "float"), ("None", "str")]
    for raw, kind in cases:
        assert forms.parse_value(raw, forms.FieldSpec("x", kind)) == jforms.parse_value(
            raw, jforms.FieldSpec("x", kind))
    with pytest.raises(ValueError):
        forms.parse_value("3", forms.FieldSpec("l", "list"))
    with pytest.raises(ValueError):
        forms.FieldSpec("x", "volume")


@pytest.mark.parametrize("scan,action", _scan_actions(), ids=lambda v: getattr(v, "NAME", v))
def test_generated_command_parses_with_the_ports_parser(scan, action):
    """Every action's form, filled with its defaults (and a value for each
    required field), gives a command string that the port's parser reads
    back, and the same string as the JAX package's form."""
    from dosma_tpu import cli as jcli
    from dosma_tpu_torch.cli import _build_parser

    fill = {"weights_dir": "/w", "model": "iwoai-2019-t6", "batch_size": "4",
            "target_path": "/t.nii.gz"}
    jscan = next(s for s in jcli.SUPPORTED_SCAN_TYPES if s.NAME == scan.NAME)
    cmds = []
    for mod, s in ((forms, scan), (jforms, jscan)):
        _, fields = mod.action_fields(s, action)
        values = {f.name: (fill.get(f.name, "" if f.default is None else str(f.default)), f)
                  for f in fields}
        cmds.append(mod.build_cli_string(scan.NAME, action, dicom_path="/d", save_path="/s",
                                         tissues=["fc"], values=values))
    assert cmds[0] == cmds[1]
    parser, _flags = _build_parser()
    args = vars(parser.parse_args(cmds[0].split()))
    assert args["scan"] == scan.NAME and args["scan_action"] == action
    assert args["dicom"] == "/d" and args["fc"] is True


def test_cli_string_shape():
    spec_b = forms.FieldSpec("rss", "bool", flag="--rss")
    spec_f = forms.FieldSpec("beta", "float")
    cmd = forms.build_cli_string("qdess", "t2", dicom_path="/d", save_path="/s", tissues=["fc"],
                                 values={"rss": ("True", spec_b), "beta": ("1.5", spec_f)})
    assert cmd == "--d /d --s /s qdess --fc t2 --rss --beta 1.5"


# ----------------------------------------------------------------------
# FileDialogReader (dialogs injected)
# ----------------------------------------------------------------------
class _Var:
    def __init__(self):
        self.value = None

    def set(self, v):
        self.value = v


def test_dialog_reader_loads_a_volume(tmp_path):
    path = str(tmp_path / "vol.nii.gz")
    arr = np.arange(48, dtype=np.float32).reshape(4, 4, 3)
    dt.NiftiWriter().save(dt.MedicalVolume(arr, np.eye(4)), path)
    var = _Var()
    reader = FileDialogReader(string_var=var, ask_open=lambda **kw: (path,))
    vol = reader.load_volume()
    assert isinstance(vol, dt.MedicalVolume) and vol.shape == (4, 4, 3)
    np.testing.assert_array_equal(vol.A, arr)
    assert var.value == path and reader._last_dir == str(tmp_path)


def test_dialog_reader_paths(tmp_path):
    dcm = tmp_path / "I0001.dcm"
    dcm.write_bytes(b"")
    assert FileDialogReader(ask_open=lambda **kw: (str(dcm),)).get_volume_filepath() == str(
        tmp_path)
    reader = FileDialogReader(ask_open=lambda **kw: (), ask_dir=lambda **kw: "")
    assert reader.get_volume_filepath() is None and reader.get_filepath() is None
    assert reader.get_dirpath() is None and reader.get_save_dirpath() is None


# ----------------------------------------------------------------------
# WidgetLogger, label2rgb, the preferences validator, the error surface
# ----------------------------------------------------------------------
class _StubText:
    def __init__(self):
        self.lines, self.state = [], None

    def after(self, _delay, fn, *args):
        fn(*args)

    def configure(self, state=None):
        self.state = state

    def insert(self, index, text):
        assert self.state == "normal"
        self.lines.append(text)

    def see(self, index):
        pass


def test_widget_logger_appends_and_relocks():
    widget = _StubText()
    handler = WidgetLogger(widget)
    logger = logging.getLogger("dosma_tpu_torch.test_gui_console")
    logger.addHandler(handler)
    try:
        logger.warning("hello %s", "world")
    finally:
        logger.removeHandler(handler)
    assert widget.lines == ["WARNING: hello world\n"] and widget.state == "disabled"


@pytest.mark.parametrize("alpha", [0.3, 0.5])
def test_label2rgb_equals_the_jax_packages(alpha):
    rs = np.random.RandomState(0)
    im = rs.rand(16, 12).astype(np.float32)
    labels = rs.randint(0, 9, (16, 12))
    np.testing.assert_array_equal(label2rgb(im, labels, alpha), jlabel2rgb(im, labels, alpha))
    assert np.all(label2rgb(np.ones((3, 3)), np.zeros((3, 3), np.int32)) == 0)
    with pytest.raises(ValueError):
        label2rgb(np.zeros((3, 3)), np.zeros((4, 4), np.int32))


def test_number_validator_prefixes():
    from dosma_tpu_torch.gui.preferences_viewer import PreferencesViewer

    vfloat = PreferencesViewer._make_number_validator(float)
    assert vfloat("") and vfloat("-") and vfloat("3.") and vfloat("3.5") and not vfloat("abc")
    vint = PreferencesViewer._make_number_validator(int)
    assert vint("42") and not vint("4.2")


def test_gui_errors_headless(caplog):
    from dosma_tpu_torch.gui.gui_errors import gui_error_handler, show_error

    with caplog.at_level(logging.ERROR, logger="dosma_tpu_torch.gui.gui_errors"):
        assert show_error("Boom", "something broke") is False
    assert "something broke" in caplog.text
    status = _Var()

    @gui_error_handler(title="Action failed", status_var=status)
    def boom():
        raise ValueError("bad input")

    with caplog.at_level(logging.ERROR):
        assert boom() is None
    assert status.value == "error: bad input" and "bad input" in caplog.text
    assert gui_error_handler(lambda x: x * 2)(21) == 42


# ----------------------------------------------------------------------
# The viewer reads a volume's pixels once
# ----------------------------------------------------------------------
class _Slider:
    def configure(self, **kw):
        self.to = kw.get("to")

    def set(self, v):
        self.value = v


class _Event:
    button = "up"


def headless_viewer():
    """An ImageViewer without its widgets: a stub slider, no drawing."""
    viewer = ImageViewer.__new__(ImageViewer)
    viewer._volume = viewer._mask = viewer._volume_arr = viewer._mask_arr = None
    viewer._index, viewer._alpha = 0, 0.3
    viewer.slider = _Slider()
    viewer.drawn = 0

    def draw():
        viewer.drawn += 1
    viewer._draw = draw
    return viewer


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_viewer_copies_the_pixels_once(kind, monkeypatch):
    arr = np.random.RandomState(0).rand(8, 6, 5).astype(np.float32)
    mask = (arr > 0.5).astype(np.uint8)
    vol = dt.MedicalVolume(torch.from_numpy(arr) if kind == "tensor" else arr, np.eye(4))
    calls = []
    original = ImageViewer._array
    monkeypatch.setattr(ImageViewer, "_array",
                        staticmethod(lambda x: calls.append(1) or original(x)))
    viewer = headless_viewer()
    viewer.set_volume(vol, dt.MedicalVolume(mask, np.eye(4)))
    assert len(calls) == 2 and viewer.slider.to == 4 and viewer._index == 2
    for _ in range(3):
        viewer._on_scroll(_Event())
        viewer._on_slider("1")
    assert len(calls) == 2 and viewer._index == 1 and viewer.drawn > 3
    assert isinstance(viewer._volume_arr, np.ndarray)
    np.testing.assert_array_equal(viewer._volume_arr, arr)
    np.testing.assert_array_equal(viewer._mask_arr, mask)
    with pytest.raises(ValueError, match="does not match"):
        viewer.set_mask(np.zeros((2, 2, 2), np.uint8))


# ----------------------------------------------------------------------
# Windows (need a display)
# ----------------------------------------------------------------------
@pytest.mark.skipif(not os.environ.get("DISPLAY"), reason="no display")
def test_full_app_constructs():  # pragma: no cover - needs an X display
    from dosma_tpu_torch.gui.ims import DosmaViewer

    viewer = DosmaViewer()
    assert set(viewer.tissue_vars) == {"fc", "men", "tc", "pc"}
    assert "pid" in viewer.knee_vargin()
    viewer.root.update_idletasks()
    viewer.root.destroy()
