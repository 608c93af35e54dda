"""Main GUI application of the PyTorch port (counterpart of
``dosma_tpu/gui/ims.py``).

Tkinter app with four tabs:

- **Analyze**: scan selection, tissue checkboxes, per-action parameter forms
  generated from the same ``cmd_line_actions`` reflection the CLI uses
  (via :class:`~dosma_tpu_torch.gui.dosma_gui.ScanReader`), plus a live
  preview of the equivalent command-line string.
- **Knee**: the knee workflow (pid, medial→lateral, tissue and
  quantitative-value checkboxes).
- **Viewer**: slice scrolling with multi-label mask overlay and on-the-fly
  orientation reformat.
- **Preferences**: typed editor over all preference leaves.

A console pane at the bottom mirrors the log stream. Scan actions run in a
worker thread on the default device (a module global, which the thread
sees), so a card volume's pixels come back to the host only where the
viewer shows them.
"""

from __future__ import annotations

import logging
import threading

__all__ = ["DosmaViewer"]

_logger = logging.getLogger(__name__)


class DosmaViewer:
    """Entry-point GUI class. Instantiate and call :meth:`mainloop`."""

    def __init__(self, root=None):
        import tkinter as tk
        from tkinter import ttk

        self.root = root or tk.Tk()
        self.root.title("DOSMA-TPU-TORCH")
        self.root.geometry("980x760")

        notebook = ttk.Notebook(self.root)
        notebook.pack(fill=tk.BOTH, expand=True)

        self.scan_frame = tk.Frame(notebook)
        self.knee_frame = tk.Frame(notebook)
        self.viewer_frame = tk.Frame(notebook)
        self.pref_frame = tk.Frame(notebook)
        notebook.add(self.scan_frame, text="Analyze")
        notebook.add(self.knee_frame, text="Knee")
        notebook.add(self.viewer_frame, text="Viewer")
        notebook.add(self.pref_frame, text="Preferences")

        self._build_scan_tab()
        self._build_knee_tab()

        from dosma_tpu_torch.gui.im_viewer import ImageViewer
        from dosma_tpu_torch.gui.preferences_viewer import PreferencesViewer

        self.preferences_viewer = PreferencesViewer(self.pref_frame)
        self.image_viewer = ImageViewer(self.viewer_frame)

        self._build_console()

    # ------------------------------------------------------------------
    # Console pane
    # ------------------------------------------------------------------
    def _build_console(self):
        import tkinter as tk

        from dosma_tpu_torch.gui.gui_utils.console_output import WidgetLogger

        self.console = tk.Text(self.root, height=7, bg="#111", fg="#ddd")
        self.console.pack(side=tk.BOTTOM, fill=tk.X)
        self._console_handler = WidgetLogger(self.console)
        logging.getLogger("dosma_tpu_torch").addHandler(self._console_handler)

    # ------------------------------------------------------------------
    # Analyze tab
    # ------------------------------------------------------------------
    def _build_scan_tab(self):
        import tkinter as tk
        from tkinter import ttk

        from dosma_tpu_torch.cli import SUPPORTED_SCAN_TYPES
        from dosma_tpu_torch.gui.dosma_gui import ScanReader
        from dosma_tpu_torch.gui.gui_utils.filedialog_reader import FileDialogReader
        from dosma_tpu_torch.msk import knee

        frame = self.scan_frame
        self.dicom_var = tk.StringVar()
        self.save_var = tk.StringVar()

        def browse(var):
            reader = FileDialogReader(string_var=var)
            return reader.get_dirpath

        row = 0
        tk.Label(frame, text="DICOM directory:").grid(row=row, column=0, sticky="w")
        tk.Entry(frame, textvariable=self.dicom_var, width=50).grid(row=row, column=1)
        tk.Button(frame, text="Browse", command=browse(self.dicom_var)).grid(row=row, column=2)
        row += 1
        tk.Label(frame, text="Save directory:").grid(row=row, column=0, sticky="w")
        tk.Entry(frame, textvariable=self.save_var, width=50).grid(row=row, column=1)
        tk.Button(frame, text="Browse", command=browse(self.save_var)).grid(row=row, column=2)
        row += 1

        tk.Label(frame, text="Scan:").grid(row=row, column=0, sticky="w")
        self.scan_var = tk.StringVar(value=SUPPORTED_SCAN_TYPES[-1].NAME)
        scan_menu = ttk.Combobox(
            frame,
            textvariable=self.scan_var,
            values=[s.NAME for s in SUPPORTED_SCAN_TYPES],
            state="readonly",
        )
        scan_menu.grid(row=row, column=1, sticky="w")
        scan_menu.bind("<<ComboboxSelected>>", lambda e: self._refresh_actions())
        row += 1

        # Tissue checkboxes (shared with the knee tab's tissue list).
        tk.Label(frame, text="Tissues:").grid(row=row, column=0, sticky="nw")
        tissue_frame = tk.Frame(frame)
        tissue_frame.grid(row=row, column=1, sticky="w")
        self.tissue_vars = {}
        for i, tcls in enumerate(knee.SUPPORTED_TISSUES):
            var = tk.BooleanVar(value=tcls.STR_ID == "fc")
            self.tissue_vars[tcls.STR_ID] = var
            tk.Checkbutton(tissue_frame, text=tcls.FULL_NAME, variable=var).grid(
                row=0, column=i, sticky="w"
            )
        row += 1

        tk.Label(frame, text="Action:").grid(row=row, column=0, sticky="w")
        self.action_var = tk.StringVar()
        self.action_menu = ttk.Combobox(frame, textvariable=self.action_var, state="readonly")
        self.action_menu.grid(row=row, column=1, sticky="w")
        self.action_menu.bind("<<ComboboxSelected>>", lambda e: self._refresh_params())
        row += 1

        self.param_frame = tk.Frame(frame)
        self.param_frame.grid(row=row, column=0, columnspan=4, sticky="nsew")
        self.scan_reader = ScanReader(self.param_frame)
        row += 1

        # Live equivalent-CLI preview.
        self.cmd_var = tk.StringVar()
        tk.Label(frame, text="CLI equivalent:").grid(row=row, column=0, sticky="w")
        tk.Entry(frame, textvariable=self.cmd_var, width=80, state="readonly").grid(
            row=row, column=1, columnspan=3, sticky="ew"
        )
        row += 1

        self.run_button = tk.Button(frame, text="Run", command=self._run_action)
        self.run_button.grid(row=row, column=1, pady=8)
        self.status_var = tk.StringVar(value="ready")
        tk.Label(frame, textvariable=self.status_var).grid(row=row, column=2)

        self._refresh_actions()

    def _scan_type(self):
        from dosma_tpu_torch.cli import SUPPORTED_SCAN_TYPES

        for s in SUPPORTED_SCAN_TYPES:
            if s.NAME == self.scan_var.get():
                return s

    def _selected_tissues(self):
        return [sid for sid, var in self.tissue_vars.items() if var.get()]

    def _refresh_actions(self):
        scan = self._scan_type()
        names = [w.name for _, w in scan.cmd_line_actions()]
        self.action_menu.configure(values=names)
        if names:
            self.action_var.set(names[0])
        self._refresh_params()

    def _refresh_params(self):
        scan = self._scan_type()
        if not self.action_var.get():
            return
        self.scan_reader.show_action_params(scan, self.action_var.get())
        self._update_cmd_preview()

    def _update_cmd_preview(self):
        try:
            self.cmd_var.set(
                self.scan_reader.get_cmd_line_str(
                    dicom_path=self.dicom_var.get() or None,
                    save_path=self.save_var.get() or None,
                    tissues=self._selected_tissues(),
                )
            )
        except Exception:  # incomplete form — preview is best-effort
            self.cmd_var.set("")

    def _ui(self, fn):
        """Marshal a UI mutation onto the Tk main thread (Tkinter is not
        thread-safe; worker threads must never touch widgets directly)."""
        self.root.after(0, fn)

    def _run_action(self):
        from dosma_tpu_torch.msk import knee

        self.status_var.set("running...")
        self.run_button.configure(state="disabled")
        self._update_cmd_preview()
        # Snapshot EVERY Tk read on the main thread — the worker must not
        # touch Tcl at all (reads are as unsafe as writes).
        job = {
            "scan_type": self._scan_type(),
            "action": self.action_var.get(),
            "dicom_path": self.dicom_var.get() or None,
            "save_path": self.save_var.get() or None,
            "kwargs": self.scan_reader.get_kwargs(),
            "tissue_classes": [
                cls for cls in knee.SUPPORTED_TISSUES
                if self.tissue_vars[cls.STR_ID].get()
            ],
        }
        threading.Thread(target=self._run_action_impl, args=(job,), daemon=True).start()

    def _run_action_impl(self, job):
        try:
            from dosma_tpu_torch.cli import CommandLineScanContainer, get_model
            from dosma_tpu_torch.defaults import preferences

            scan_type = job["scan_type"]
            action_name = job["action"]
            save_path = job["save_path"]
            scan = CommandLineScanContainer(
                scan_type,
                dicom_path=job["dicom_path"],
                load_path=save_path,
            )
            kwargs = job["kwargs"]

            tissues = [cls() for cls in job["tissue_classes"]]

            # Segmentation forms expand into weights_dir/model/batch_size;
            # mirror cli.handle_segmentation's weights resolution.
            if "weights_dir" in kwargs:
                if not tissues:
                    raise ValueError("Select at least one tissue to segment")
                weights_dir = kwargs.pop("weights_dir")
                model_name = kwargs.pop("model")
                batch_size = kwargs.pop("batch_size", preferences.segmentation_batch_size)
                weights = [t.find_weights(weights_dir) for t in tissues]
                if any(w != weights[0] for w in weights):
                    raise ValueError(
                        "Selected tissues resolve to different weights files; "
                        "segment them one at a time"
                    )
                dims = scan.scan.get_dimensions()
                model = get_model(
                    model_name, input_shape=(dims[0], dims[1], 1), weights_path=weights[0]
                )
                model.batch_size = batch_size
                kwargs["model"] = model
                kwargs["tissue"] = tissues[0] if len(tissues) == 1 else tissues
            elif tissues:
                import inspect as _inspect

                sig_params = _inspect.signature(
                    getattr(scan_type, action_name)
                ).parameters
                if "tissue" in sig_params:
                    kwargs["tissue"] = tissues[0]

            action = getattr(scan, action_name)
            if "tissue" in kwargs and isinstance(kwargs.get("tissue"), list):
                action(**kwargs)
            elif tissues and "tissue" in kwargs:
                # Like the CLI, run the action once per selected tissue
                # (``cli.py`` loops ``for tissue in tissues``).
                for t in tissues:
                    action(**{**kwargs, "tissue": t})
            else:
                action(**kwargs)
            if save_path:
                scan.save(save_path, image_data_format=preferences.image_data_format)
            vols = scan.scan.volumes
            vol = vols[0] if isinstance(vols, (list, tuple)) else vols
            self._ui(lambda: self.image_viewer.set_volume(vol))
            self._ui(lambda: self.status_var.set("done"))
        except Exception as e:  # pragma: no cover - GUI error path
            from dosma_tpu_torch.gui.gui_errors import show_error

            _logger.exception("GUI action failed")
            msg = f"error: {e}"
            err_text = str(e)
            # Tk calls must run on the main loop thread (this runs in the
            # worker): marshal the dialog like every other widget access.
            self._ui(lambda: show_error("Scan action failed", err_text))
            self._ui(lambda: self.status_var.set(msg))
        finally:
            self._ui(lambda: self.run_button.configure(state="normal"))

    # ------------------------------------------------------------------
    # Knee workflow tab
    # ------------------------------------------------------------------
    def _build_knee_tab(self):
        import tkinter as tk

        from dosma_tpu_torch.gui.gui_utils.filedialog_reader import FileDialogReader
        from dosma_tpu_torch.msk import knee

        frame = self.knee_frame
        row = 0

        tk.Label(frame, text="Patient ID:").grid(row=row, column=0, sticky="w")
        self.knee_pid_var = tk.StringVar()
        tk.Entry(frame, textvariable=self.knee_pid_var, width=30).grid(row=row, column=1, sticky="w")
        row += 1

        tk.Label(frame, text="Load directory:").grid(row=row, column=0, sticky="w")
        self.knee_load_var = tk.StringVar()
        tk.Entry(frame, textvariable=self.knee_load_var, width=50).grid(row=row, column=1)
        tk.Button(
            frame,
            text="Browse",
            command=FileDialogReader(string_var=self.knee_load_var).get_dirpath,
        ).grid(row=row, column=2)
        row += 1

        self.knee_ml_var = tk.BooleanVar(value=False)
        tk.Checkbutton(
            frame, text="slices go medial → lateral", variable=self.knee_ml_var
        ).grid(row=row, column=1, sticky="w")
        row += 1

        tk.Label(frame, text="Tissues:").grid(row=row, column=0, sticky="nw")
        tframe = tk.Frame(frame)
        tframe.grid(row=row, column=1, sticky="w")
        self.knee_tissue_vars = {}
        for i, tcls in enumerate(knee.SUPPORTED_TISSUES):
            var = tk.BooleanVar(value=False)
            self.knee_tissue_vars[tcls.STR_ID] = var
            tk.Checkbutton(tframe, text=tcls.FULL_NAME, variable=var).grid(
                row=i // 2, column=i % 2, sticky="w"
            )
        row += 1

        tk.Label(frame, text="Quantitative values:").grid(row=row, column=0, sticky="nw")
        qframe = tk.Frame(frame)
        qframe.grid(row=row, column=1, sticky="w")
        self.knee_qv_vars = {}
        for i, qv in enumerate(knee.SUPPORTED_QUANTITATIVE_VALUES):
            var = tk.BooleanVar(value=False)
            self.knee_qv_vars[qv.name.lower()] = var
            tk.Checkbutton(qframe, text=qv.name.lower(), variable=var).grid(
                row=0, column=i, sticky="w"
            )
        row += 1

        self.knee_run_button = tk.Button(frame, text="Run knee analysis", command=self._run_knee)
        self.knee_run_button.grid(row=row, column=1, pady=8)
        self.knee_status_var = tk.StringVar(value="ready")
        tk.Label(frame, textvariable=self.knee_status_var).grid(row=row, column=2)

    def knee_vargin(self) -> dict:
        """Current knee-tab state as the vargin dict ``handle_knee`` takes."""
        import uuid

        from dosma_tpu_torch.msk import knee

        vargin = {
            knee.LOAD_KEY: self.knee_load_var.get() or None,
            knee.SAVE_KEY: self.knee_load_var.get() or None,
            knee.PID_KEY: self.knee_pid_var.get() or str(uuid.uuid4()),
            knee.MEDIAL_TO_LATERAL_KEY: bool(self.knee_ml_var.get()),
            knee.TISSUES_KEY: [
                cls()
                for cls in knee.SUPPORTED_TISSUES
                if self.knee_tissue_vars[cls.STR_ID].get()
            ],
        }
        for name, var in self.knee_qv_vars.items():
            vargin[name] = bool(var.get())
        return vargin

    def _run_knee(self):
        self.knee_status_var.set("running...")
        self.knee_run_button.configure(state="disabled")

        def impl():
            try:
                from dosma_tpu_torch.msk import knee

                knee.handle_knee(self.knee_vargin())
                self.knee_status_var.set("done")
            except Exception as e:  # pragma: no cover - GUI error path
                from dosma_tpu_torch.gui.gui_errors import show_error

                _logger.exception("knee workflow failed")
                err_text = str(e)
                self._ui(lambda: show_error("Knee workflow failed", err_text))
                self.knee_status_var.set(f"error: {e}")
            finally:
                self.knee_run_button.configure(state="normal")

        threading.Thread(target=impl, daemon=True).start()

    def mainloop(self):
        self.root.mainloop()


def main():  # pragma: no cover - needs display
    DosmaViewer().mainloop()


if __name__ == "__main__":  # pragma: no cover
    main()
