"""GUI entry point of the PyTorch port (counterpart of ``dosma_tpu/app.py``).

Run: ``python -m dosma_tpu_torch.app`` (needs a display and tkinter; the
viewer also needs matplotlib).
"""

from dosma_tpu_torch.gui.ims import DosmaViewer


def main():  # pragma: no cover - needs display
    DosmaViewer().mainloop()


if __name__ == "__main__":  # pragma: no cover
    main()
