"""CPU tests of the benchmark harness (``python -m pytest qmri_bench/tests``):
small shapes, the program on the CPU through its plain versions."""

import pytest
import torch

SMALL = {
    "t2_config1": {"shape": [48, 48, 8],
                   "label_boxes": {"1": [[4, 44], [4, 44], [0, 4]], "2": [[8, 40], [8, 40], [4, 8]]}},
    "cubequant_t1rho": {"shape": [32, 32, 12]},
}
CELLS = ["t2_config1.card_fit", "t2_config1.host_fit", "cubequant_t1rho.t1rho_fit",
         "cubequant_t1rho.register_pair"]


@pytest.fixture(autouse=True)
def _cpu():
    import dosma_tpu_torch as dt

    torch.set_num_threads(2)
    with dt.default_device("cpu"):
        yield


def small_run(cell, seed=7, seconds=0.05, **kw):
    """One run of ``cell`` on the CPU at a small size."""
    import io

    from qmri_bench.run import run_cell

    return run_cell(cell, seed, seconds, 0, torch.device("cpu"),
                    cfg_override=SMALL[cell.split(".")[0]], log=io.StringIO(), **kw)
