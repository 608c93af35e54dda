"""Slice-scroll image viewer with multi-label mask overlay (counterpart of
``dosma_tpu/gui/im_viewer.py``): load a volume or mask from dialogs,
reformat the orientation, blend labels into RGB.

A card volume's pixels are copied to the host once, when the volume or mask
is set (:meth:`ImageViewer.set_volume`, :meth:`ImageViewer.set_mask`), and
every scroll reads that copy. The overlay math (:func:`label2rgb`) is a pure
function, so it is tested headless; only widget wiring needs a display, and
matplotlib is imported only when a viewer is built.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["ImageViewer", "label2rgb"]

# Distinct overlay colors for up to 6 label classes (RGB in [0, 1]).
_LABEL_COLORS = np.array(
    [
        [0.90, 0.10, 0.10],  # 1: red
        [0.10, 0.70, 0.15],  # 2: green
        [0.15, 0.35, 0.95],  # 3: blue
        [0.95, 0.80, 0.10],  # 4: yellow
        [0.80, 0.15, 0.85],  # 5: magenta
        [0.10, 0.80, 0.85],  # 6: cyan
    ]
)


def label2rgb(im2d: np.ndarray, labels2d: np.ndarray, alpha: float = 0.3) -> np.ndarray:
    """Blend an integer label map onto a grayscale slice.

    ``im2d`` (H, W) is min-max normalized to [0, 1]; label ``k`` (k >= 1)
    blends ``_LABEL_COLORS[(k-1) % 6]`` with weight ``alpha``. Label 0 is
    background (untouched). Returns (H, W, 3) float RGB.
    """
    im2d = np.asarray(im2d, np.float32)
    labels2d = np.asarray(labels2d)
    if im2d.shape != labels2d.shape:
        raise ValueError(f"image {im2d.shape} vs labels {labels2d.shape}")
    lo, hi = float(im2d.min()), float(im2d.max())
    gray = (im2d - lo) / (hi - lo) if hi > lo else np.zeros_like(im2d)
    rgb = np.repeat(gray[..., None], 3, axis=-1)
    for k in np.unique(labels2d):
        k = int(k)
        if k <= 0:
            continue
        color = _LABEL_COLORS[(k - 1) % len(_LABEL_COLORS)]
        sel = labels2d == k
        rgb[sel] = (1 - alpha) * rgb[sel] + alpha * color
    return rgb


class ImageViewer:
    """Matplotlib-in-Tk viewer: scroll slices, overlay label masks, load
    volume/mask from file dialogs, reformat orientation on the fly."""

    def __init__(self, parent, volume=None, mask=None):
        import tkinter as tk
        from tkinter import ttk

        from matplotlib.backends.backend_tkagg import FigureCanvasTkAgg
        from matplotlib.figure import Figure

        from dosma_tpu_torch.gui.gui_utils.filedialog_reader import FileDialogReader

        self.parent = parent
        self._volume = None  # MedicalVolume, ndarray or tensor
        self._mask = None
        self._volume_arr = None  # host copies of the pixels, made once
        self._mask_arr = None
        self._index = 0
        self._alpha = 0.3

        bar = tk.Frame(parent)
        bar.pack(side=tk.TOP, fill=tk.X)
        self._dialogs = FileDialogReader()
        tk.Button(bar, text="Load volume", command=self._load_volume_cb).pack(side=tk.LEFT)
        tk.Button(bar, text="Load mask", command=self._load_mask_cb).pack(side=tk.LEFT)

        tk.Label(bar, text="orientation:").pack(side=tk.LEFT, padx=(12, 2))
        self.orient_var = tk.StringVar()
        self.orient_menu = ttk.Combobox(
            bar, textvariable=self.orient_var, state="readonly", width=16,
            values=["(native)", "sagittal", "coronal", "axial"],
        )
        self.orient_menu.set("(native)")
        self.orient_menu.pack(side=tk.LEFT)
        self.orient_menu.bind("<<ComboboxSelected>>", lambda e: self._reformat())

        self.figure = Figure(figsize=(5, 5))
        self.ax = self.figure.add_subplot(111)
        self.canvas = FigureCanvasTkAgg(self.figure, master=parent)
        self.canvas.get_tk_widget().pack(side=tk.TOP, fill=tk.BOTH, expand=True)
        self.canvas.mpl_connect("scroll_event", self._on_scroll)

        self.slider = tk.Scale(
            parent, from_=0, to=0, orient=tk.HORIZONTAL, command=self._on_slider
        )
        self.slider.pack(side=tk.BOTTOM, fill=tk.X)

        if volume is not None:
            self.set_volume(volume, mask)

    # -- data ------------------------------------------------------------
    def set_volume(self, volume, mask=None):
        self._volume = volume
        self._volume_arr = self._array(volume)
        self._mask = self._mask_arr = None
        if mask is not None:
            self.set_mask(mask)
        arr = self._volume_arr
        self._index = arr.shape[-1] // 2
        self.slider.configure(to=arr.shape[-1] - 1)
        self.slider.set(self._index)
        self._draw()

    def set_mask(self, mask):
        marr = self._array(mask)
        varr = self._volume_arr
        if varr is not None and marr.shape[:3] != varr.shape[:3]:
            raise ValueError(f"mask {marr.shape} does not match volume {varr.shape}")
        self._mask, self._mask_arr = mask, marr
        self._draw()

    @staticmethod
    def _array(x) -> np.ndarray:
        """The pixels of a volume, tensor or array as a host array: a card
        tensor's copied to the host (one copy), host data without a copy."""
        x = getattr(x, "A", x)
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return np.asarray(x)

    # -- callbacks ---------------------------------------------------------
    def _load_volume_cb(self):  # pragma: no cover - dialog path
        vol = self._dialogs.load_volume("Select volume file")
        if vol is not None:
            self.set_volume(vol)

    def _load_mask_cb(self):  # pragma: no cover - dialog path
        mask = self._dialogs.load_volume("Select mask file")
        if mask is not None:
            self.set_mask(mask)

    def _reformat(self):
        """Reorient MedicalVolumes (plain arrays only support native)."""
        from dosma_tpu_torch.core.orientation import AXIAL, CORONAL, SAGITTAL

        name = self.orient_var.get()
        ornt = {"sagittal": SAGITTAL, "coronal": CORONAL, "axial": AXIAL}.get(name)
        if ornt is None or not hasattr(self._volume, "reformat"):
            return
        self._volume = self._volume.reformat(ornt)
        if self._mask is not None and hasattr(self._mask, "reformat"):
            self._mask = self._mask.reformat(ornt)
        self.set_volume(self._volume, self._mask)

    def _on_scroll(self, event):
        if self._volume is None:
            return
        step = 1 if event.button == "up" else -1
        last = self._volume_arr.shape[-1] - 1
        self._index = int(np.clip(self._index + step, 0, last))
        self.slider.set(self._index)
        self._draw()

    def _on_slider(self, value):
        if self._volume is None:
            return
        self._index = int(value)
        self._draw()

    # -- render ------------------------------------------------------------
    def _draw(self):
        if self._volume is None:
            return
        self.ax.clear()
        im = self._volume_arr[..., self._index]
        if self._mask_arr is not None:
            labels = self._mask_arr[..., self._index].astype(np.int32)
            self.ax.imshow(label2rgb(im, labels, self._alpha))
        else:
            self.ax.imshow(im, cmap="gray")
        self.ax.set_title(f"slice {self._index}")
        self.ax.axis("off")
        self.canvas.draw_idle()
