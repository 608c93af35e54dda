"""Host I/O helpers (counterpart of ``dosma_tpu/utils/io_utils.py``; a
re-design of DOSMA's ``dosma/utils/io_utils.py``).

``mkdirs``, pickle save/load, HDF5 save/load, and multi-sheet table export.
``save_tables`` writes ``.xlsx`` via a minimal from-scratch writer (openpyxl
is unavailable in this environment) — xlsx is just zipped XML.
"""

from __future__ import annotations

import os
import pickle
import zipfile
from typing import Dict, Sequence

__all__ = ["mkdirs", "save_pik", "load_pik", "save_h5", "load_h5", "save_tables"]


def mkdirs(dir_path: str) -> str:
    os.makedirs(dir_path, exist_ok=True)
    return dir_path


def save_pik(filepath: str, data):
    dirname = os.path.dirname(filepath)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    with open(filepath, "wb") as f:
        pickle.dump(data, f)


def load_pik(filepath: str):
    with open(filepath, "rb") as f:
        return pickle.load(f)


def save_h5(filepath: str, data: Dict):
    import h5py

    dirname = os.path.dirname(filepath)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    with h5py.File(filepath, "w") as f:
        for k, v in data.items():
            f.create_dataset(k, data=v)


def load_h5(filepath: str) -> Dict:
    import h5py

    if not os.path.isfile(filepath):
        raise FileNotFoundError(f"{filepath} does not exist")
    out = {}
    with h5py.File(filepath, "r") as f:
        for k in f.keys():
            out[k] = f[k][()]
    return out


# ----------------------------------------------------------------------
# Minimal xlsx writer (multi-sheet): xlsx == zip of OOXML parts.
# ----------------------------------------------------------------------
def _xml_escape(s: str) -> str:
    return (
        str(s)
        .replace("&", "&amp;")
        .replace("<", "&lt;")
        .replace(">", "&gt;")
        .replace('"', "&quot;")
    )


def _col_name(idx: int) -> str:
    name = ""
    idx += 1
    while idx:
        idx, rem = divmod(idx - 1, 26)
        name = chr(65 + rem) + name
    return name


def _sheet_xml(df) -> str:
    import numpy as np

    rows = []
    header_cells = "".join(
        f'<c r="{_col_name(j)}1" t="inlineStr"><is><t>{_xml_escape(col)}</t></is></c>'
        for j, col in enumerate(df.columns)
    )
    rows.append(f'<row r="1">{header_cells}</row>')
    for i, (_, rec) in enumerate(df.iterrows(), start=2):
        cells = []
        for j, val in enumerate(rec):
            ref = f"{_col_name(j)}{i}"
            if isinstance(val, (int, float, np.integer, np.floating)) and not isinstance(val, bool):
                if val != val:  # NaN
                    cells.append(f'<c r="{ref}" t="inlineStr"><is><t>NaN</t></is></c>')
                else:
                    cells.append(f'<c r="{ref}"><v>{val}</v></c>')
            else:
                cells.append(f'<c r="{ref}" t="inlineStr"><is><t>{_xml_escape(val)}</t></is></c>')
        rows.append(f'<row r="{i}">{"".join(cells)}</row>')
    return (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<worksheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">'
        f"<sheetData>{''.join(rows)}</sheetData></worksheet>"
    )


def save_tables(filepath: str, data_frames: Sequence, sheet_names: Sequence[str] = None):
    """Write DataFrames to a multi-sheet ``.xlsx`` (ref ``io_utils.py:save_tables``)."""
    dirname = os.path.dirname(filepath)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    if sheet_names is None:
        sheet_names = [f"Sheet{i + 1}" for i in range(len(data_frames))]
    assert len(sheet_names) == len(data_frames)

    n = len(data_frames)
    sheets_meta = "".join(
        f'<sheet name="{_xml_escape(sheet_names[i][:31])}" sheetId="{i + 1}" r:id="rId{i + 1}"/>'
        for i in range(n)
    )
    workbook = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" '
        'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">'
        f"<sheets>{sheets_meta}</sheets></workbook>"
    )
    wb_rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
        + "".join(
            f'<Relationship Id="rId{i + 1}" Type="http://schemas.openxmlformats.org/'
            f'officeDocument/2006/relationships/worksheet" Target="worksheets/sheet{i + 1}.xml"/>'
            for i in range(n)
        )
        + "</Relationships>"
    )
    content_types = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">'
        '<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.'
        'relationships+xml"/>'
        '<Default Extension="xml" ContentType="application/xml"/>'
        '<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-'
        'officedocument.spreadsheetml.sheet.main+xml"/>'
        + "".join(
            f'<Override PartName="/xl/worksheets/sheet{i + 1}.xml" ContentType="application/'
            f'vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>'
            for i in range(n)
        )
        + "</Types>"
    )
    root_rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
        '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/'
        'relationships/officeDocument" Target="xl/workbook.xml"/></Relationships>'
    )

    with zipfile.ZipFile(filepath, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", content_types)
        z.writestr("_rels/.rels", root_rels)
        z.writestr("xl/workbook.xml", workbook)
        z.writestr("xl/_rels/workbook.xml.rels", wb_rels)
        for i, df in enumerate(data_frames):
            z.writestr(f"xl/worksheets/sheet{i + 1}.xml", _sheet_xml(df))
