"""Figures and the spreadsheet of a tissue's analytics (counterpart of
``dosma_tpu/tissues/_plot.py``): one jet map per unrolled map and one
``data.xlsx`` sheet per quantitative value. matplotlib is imported only
inside :func:`save_quant_maps_and_tables`.
"""

from __future__ import annotations

import os

import numpy as np

from dosma_tpu_torch.core.quant_vals import QuantitativeValueType
from dosma_tpu_torch.defaults import preferences
from dosma_tpu_torch.utils import io_utils

__all__ = ["save_quant_maps_and_tables"]


def save_quant_maps_and_tables(dirpath: str, quant_vals: dict, bounds: dict, ylabel: str = ""):
    """Save per-qv jet maps (with vmax bounds policy) + multi-sheet xlsx."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    q_names = []
    dfs = []
    for quant_val in QuantitativeValueType:
        if quant_val.name not in quant_vals.keys():
            continue
        q_names.append(quant_val.name)
        q_val = quant_vals[quant_val.name]
        dfs.append(q_val[1])

        q_name_dirpath = io_utils.mkdirs(os.path.join(dirpath, quant_val.name.lower()))
        for q_map_data in q_val[0]:
            filepath = os.path.join(q_name_dirpath, q_map_data["filename"])
            data_map = np.atleast_2d(q_map_data["data"])

            plt.clf()
            upper_bound = bounds[quant_val]
            if preferences.visualization_use_vmax or np.sum(data_map <= upper_bound) == 0:
                plt.imshow(data_map, cmap="jet", vmin=0.0, vmax=upper_bound)
            else:
                plt.imshow(data_map, cmap="jet")
            plt.xlabel(q_map_data.get("xlabel", "Slice"))
            plt.ylabel(q_map_data.get("ylabel", ylabel))
            plt.title(q_map_data["title"])
            clb = plt.colorbar()
            clb.ax.set_title("(ms)")
            plt.savefig(filepath)
            plt.close()

            raw_path = os.path.join(q_name_dirpath, "raw_data", q_map_data["raw_data_filename"])
            io_utils.save_pik(raw_path, q_map_data["data"])

    if dfs:
        io_utils.save_tables(os.path.join(dirpath, "data.xlsx"), dfs, q_names)
