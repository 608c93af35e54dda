"""The Tkinter GUI of the PyTorch port (counterpart of ``dosma_tpu/gui/``).

Tkinter is imported only when a window is built, and matplotlib only by the
image viewer, so every module here imports without either.
"""
