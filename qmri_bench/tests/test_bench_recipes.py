import numpy as np
import pytest
import torch

from qmri_bench import recipes
from qmri_bench.run import load_cell
from qmri_bench.tests.conftest import SMALL


def _cfg(name):
    cfg = load_cell({"t2_config1": "t2_config1.card_fit",
                     "cubequant_t1rho": "cubequant_t1rho.t1rho_fit"}[name])[2]
    cfg.update(SMALL[name])
    return cfg


@pytest.mark.parametrize("seed", [0, 2**31 + 17, 2**33 + 5])
def test_config1_repeats_per_seed(seed):
    cfg = _cfg("t2_config1")
    a = recipes.config1_scan(cfg, recipes.generator(seed, "cpu"), "cpu")
    b = recipes.config1_scan(cfg, recipes.generator(seed, "cpu"), "cpu")
    c = recipes.config1_scan(cfg, recipes.generator(seed + 1, "cpu"), "cpu")
    assert a.shape == (4, 48, 48, 8) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_config1_rates_and_labels():
    cfg = _cfg("t2_config1")
    cfg["noise_sigma"] = 0.0
    y = recipes.config1_scan(cfg, recipes.generator(3, "cpu"), "cpu").reshape(4, -1).double()
    b = torch.log(y[1] / y[0]) / 10.0
    tc = -1.0 / b
    assert float(tc.min()) >= 10.0 - 1e-3 and float(tc.max()) <= 80.0 + 1e-3
    labels = recipes.config1_labels(cfg, "cpu")
    assert set(torch.unique(labels).tolist()) == {0, 1, 2}
    assert int((labels == 1).sum()) == 40 * 40 * 4 and int((labels == 2).sum()) == 32 * 32 * 4


@pytest.mark.parametrize("rolled", [False, True])
def test_cubequant_repeats_and_rolls(rolled):
    cfg = _cfg("cubequant_t1rho")
    a = recipes.cubequant_scan(cfg, recipes.generator(9, "cpu"), "cpu", rolled)
    b = recipes.cubequant_scan(cfg, recipes.generator(9, "cpu"), "cpu", rolled)
    assert torch.equal(a, b) and a.shape == (4, 32, 32, 12)
    flat = recipes.cubequant_scan(cfg, recipes.generator(9, "cpu"), "cpu", False)
    for i in range(4):
        want = torch.roll(flat[i], (i, -i, 0), dims=(0, 1, 2)) if rolled else flat[i]
        assert torch.equal(a[i], want)


def test_condyle_arc_and_affine():
    arc = recipes.condyle_arc((192, 192, 48))
    assert arc.dtype == np.uint8 and arc.shape == (192, 192, 48)
    assert np.array_equal(arc[..., 0], arc[..., 47]) and 0 < arc.mean() < 0.2
    a = recipes.sagittal_affine((0.5, 0.6, 1.0))
    assert np.allclose(np.abs(np.linalg.det(a[:3, :3])), 0.3)
    assert np.allclose(a @ [1, 0, 0, 1], [0, 0, -0.5, 1])
