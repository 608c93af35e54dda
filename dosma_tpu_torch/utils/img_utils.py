"""Image helpers (counterpart of ``dosma_tpu/utils/img_utils.py``): slice
downsampling, and the labelled-region figure. matplotlib is imported only
where a figure is drawn (:func:`pyplot`); region colours come from its
Pastel1 map.
"""

from __future__ import annotations

import warnings

import numpy as np

__all__ = ["downsample_slice", "pyplot", "write_regions"]

DEFAULT_TEXT_SPACING = 0.1


def downsample_slice(img_array: np.ndarray, ds_factor: int, is_mask: bool = False) -> np.ndarray:
    """Bin slices in the z-direction by summation (ref ``img_utils.py:14-50``)."""
    h, w, d = img_array.shape
    pad = (-d) % ds_factor
    if pad:
        img_array = np.concatenate(
            [img_array, np.zeros((h, w, pad), img_array.dtype)], axis=-1
        )
    out = img_array.reshape(h, w, -1, ds_factor).sum(axis=-1)
    if is_mask:
        out = (out >= 1) * 1
    return out


def pyplot(figure: str):
    """matplotlib's ``pyplot`` on the Agg backend; ``None``, with a warning
    that names ``figure``, where matplotlib is not installed. A figure only
    shows data that is written beside it all the same."""
    from dosma_tpu_torch.utils import env

    if not env.package_available("matplotlib"):
        warnings.warn(f"matplotlib is not installed: {figure} not drawn")
        return None
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def write_regions(file_path: str, arr: np.ndarray, plt_dict: dict = None):
    """Save a labeled-region image with a legend (ref ``img_utils.py:52-127``);
    without matplotlib, only the checks of ``arr`` run."""
    if len(arr.shape) != 2:
        raise ValueError("`arr` must be a 2D numpy array")

    unique_vals = np.unique(arr.flatten())
    if 0 in unique_vals:
        raise ValueError("All finite values in `arr` must be >=1")
    unique_vals = unique_vals[np.isfinite(unique_vals)]
    num_unique_vals = len(unique_vals)

    plt_dict_int = {"xlabel": "", "ylabel": "", "title": "", "labels": None}
    if plt_dict:
        plt_dict_int.update(plt_dict)
    plt_dict = plt_dict_int

    labels = plt_dict["labels"] or list(unique_vals)
    if len(labels) != num_unique_vals:
        raise ValueError(f"len(labels) != num_unique_vals - {len(labels)} != {num_unique_vals}")

    plt = pyplot(file_path)
    if plt is None:
        return
    from matplotlib.lines import Line2D

    cmap = plt.get_cmap("Pastel1")
    cpal = [cmap(i % 9) for i in range(num_unique_vals)]

    arr_c = np.nan_to_num(np.array(arr))
    arr_c[arr_c > np.max(unique_vals)] = 0
    arr_rgb = np.ones([arr_c.shape[0], arr_c.shape[1], 3])

    plt.figure()
    plt.clf()
    custom_lines = []
    for i, unique_val in enumerate(unique_vals):
        i0, i1 = np.where(arr_c == unique_val)
        arr_rgb[i0, i1, ...] = np.asarray(cpal[i][:3])
        custom_lines.append(
            Line2D([], [], color=cpal[i], marker="o", linestyle="None", markersize=5)
        )

    plt.xlabel(plt_dict["xlabel"])
    plt.ylabel(plt_dict["ylabel"])
    plt.title(plt_dict["title"])
    lgd = plt.legend(
        custom_lines,
        labels,
        loc="upper center",
        bbox_to_anchor=(0.5, -DEFAULT_TEXT_SPACING),
        fancybox=True,
        shadow=True,
        ncol=3,
    )
    plt.imshow(arr_rgb)
    plt.savefig(file_path, bbox_extra_artists=(lgd,), bbox_inches="tight")
    plt.close()
