"""The port's preferences (``dosma_tpu_torch.defaults``) against the JAX
package's: the same leaves, values, type coercion, choice checks and
command-line flags; saving and loading a user file; and an import of the
port that needs no yaml.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from dosma_tpu.defaults import preferences as jprefs
from dosma_tpu_torch.defaults import _Preferences, preferences


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU."""
    from dosma_tpu_torch.core.device import default_device

    with default_device("cpu"):
        yield


@pytest.fixture
def restore():
    """Every leaf's value is put back after the test."""
    before = {path: preferences.get(path) for path in preferences.keys()}
    yield
    for path, value in before.items():
        preferences.set(path, value)


def test_leaves_and_values_equal_the_jax_package():
    assert set(preferences.keys()) == set(jprefs.cmd_line_flags())
    for path in preferences.keys():
        assert preferences.get(path) == jprefs.get(path), path


def test_cmd_line_flags_equal_the_jax_package():
    assert preferences.cmd_line_flags() == jprefs.cmd_line_flags()


def test_named_properties_equal_the_jax_package():
    for name in ("fitting_r2_threshold", "mask_dilation_rate", "mask_dilation_threshold",
                 "segmentation_batch_size", "segmentation_precision", "visualization_use_vmax",
                 "nipype_logging"):
        assert getattr(preferences, name) == getattr(jprefs, name), name
    assert preferences.image_data_format.name == jprefs.image_data_format.name
    assert preferences.segmentation_batch_size == 64


def test_get_unknown_or_inner_node_raises():
    with pytest.raises(KeyError):
        preferences.get("nonexistent/path")
    with pytest.raises(KeyError):
        preferences.get("fitting")


def test_set_coerces_like_the_jax_package(restore):
    for path, value in [("fitting/r2.threshold", "0.75"), ("segmentation/batch.size", 16.0),
                        ("visualization/use.vmax", "true"), ("visualization/use.vmax", "no"),
                        ("visualization/matplotlib/rcParams/savefig.dpi", 300)]:
        preferences.set(path, value)
        jold = jprefs.get(path)
        try:
            jprefs.set(path, value)
            assert preferences.get(path) == jprefs.get(path)
            assert type(preferences.get(path)) is type(jprefs.get(path))
        finally:
            jprefs.set(path, jold)


def test_set_checks_choices_and_types(restore):
    with pytest.raises(ValueError):
        preferences.set("data/format", "hdf5")
    preferences.set("data/format", "dicom")
    assert preferences.image_data_format.name == "dicom"
    with pytest.raises(ValueError):
        preferences.set("segmentation/batch.size", "many")
    with pytest.raises(KeyError):
        preferences.set("segmentation/nope", 1)


def test_prefix_argument(restore):
    preferences.set("precision", "bfloat16", prefix="segmentation")
    assert preferences.segmentation_precision == "bfloat16"


def test_save_and_load_a_user_file(tmp_path, restore, monkeypatch):
    import yaml

    path = tmp_path / "prefs" / "preferences.yml"
    monkeypatch.setattr(preferences, "_user_path", str(path))
    preferences.set("fitting/r2.threshold", 0.33)
    preferences.save()
    flat = yaml.safe_load(path.read_text())
    assert set(flat) == set(preferences.keys())
    assert flat["fitting/r2.threshold"] == 0.33
    # A new object reads the file at construction, skipping stale keys.
    flat["segmentation/batch.size"] = 8
    flat["segmentation/stale.key"] = 1
    path.write_text(yaml.safe_dump(flat))
    with pytest.warns(UserWarning, match="stale.key"):
        fresh = _Preferences(user_path=str(path))
    assert fresh.get("fitting/r2.threshold") == 0.33
    assert fresh.segmentation_batch_size == 8
    assert _Preferences(user_path=str(tmp_path / "absent.yml")).segmentation_batch_size == 64


def test_importing_the_port_needs_no_yaml(tmp_path):
    # yaml made unimportable: the package and its models import, and only
    # saving the preferences raises.
    code = (
        "import sys\n"
        "sys.modules['yaml'] = None\n"
        "import dosma_tpu_torch, dosma_tpu_torch.models\n"
        "from dosma_tpu_torch.defaults import preferences\n"
        "print(preferences.segmentation_batch_size)\n"
        "try:\n"
        "    preferences.save()\n"
        "except ImportError:\n"
        "    print('ImportError')\n"
    )
    env = dict(os.environ, HOME=str(tmp_path))
    repo = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["64", "ImportError"]
    assert not (tmp_path / ".dosma_tpu_torch").exists()
