"""Command-line interface of the PyTorch port (counterpart of
``dosma_tpu/cli.py``, with the same commands and flags).

Each scan's ``cmd_line_actions()`` is reflected into argparse subparsers
whose arguments come from the action's annotated signature; segmentation
groups the tissues by the weight file they share; the preferences add
global flags; ``knee`` runs the regional analytics of saved maps.

Scans are computed on the default device, the first CUDA card: a run on a
machine with no visible card exits with the device error, and never
computes on the CPU instead. ``--gpu G`` sets ``CUDA_VISIBLE_DEVICES`` before
anything touches a card (importing the package and parsing the arguments
do not), so card ``G`` becomes the default device. ``--device_load`` reads
the DICOM series straight onto the card (pinned prefetch); without it the
series is read on the host and computed on the card. The segmentation
models read ``.h5`` (Keras, needs h5py) or ``.pt`` weights.

Run: ``python -m dosma_tpu_torch.cli --dicom D --save S qdess --fc segment ...``
or ``dosma-tpu-torch ...`` once the package is installed.
"""

from __future__ import annotations

import argparse
import ast
import functools
import inspect
import logging
import os
import time
import warnings
from collections import defaultdict
from typing import Sequence

from dosma_tpu_torch.core.quant_vals import QuantitativeValueType as QV
from dosma_tpu_torch.defaults import preferences
from dosma_tpu_torch.models.seg_model import SegModel
from dosma_tpu_torch.models.util import SUPPORTED_MODELS, get_model, model_from_config
from dosma_tpu_torch.msk import knee
from dosma_tpu_torch.scan_sequences.mri.cones import Cones
from dosma_tpu_torch.scan_sequences.mri.cube_quant import CubeQuant
from dosma_tpu_torch.scan_sequences.mri.mapss import Mapss
from dosma_tpu_torch.scan_sequences.mri.qdess import QDess
from dosma_tpu_torch.scan_sequences.scans import ScanSequence
from dosma_tpu_torch.tissues.tissue import Tissue
from dosma_tpu_torch.utils import env
from dosma_tpu_torch.utils.logger import setup_logger

SUPPORTED_QUANTITATIVE_VALUES = [QV.T2, QV.T1_RHO, QV.T2_STAR]

DEBUG_KEY = "debug"
DICOM_KEY = "dicom"
SAVE_KEY = "save"
LOAD_KEY = "load"
IGNORE_EXT_KEY = "ignore_ext"
DEVICE_LOAD_KEY = "device_load"
SPLIT_BY_KEY = "split_by"
GPU_KEY = "gpu"
NUM_WORKERS_KEY = "num-workers"

SCAN_KEY = "scan"
SCAN_ACTION_KEY = "scan_action"

SEGMENTATION_MODEL_KEY = "model"
SEGMENTATION_CONFIG_KEY = "config"
SEGMENTATION_WEIGHTS_DIR_KEY = "weights_dir"
SEGMENTATION_BATCH_SIZE_KEY = "batch_size"

TISSUES_KEY = "tissues"

SUPPORTED_SCAN_TYPES = [Cones, CubeQuant, Mapss, QDess]
BASIC_TYPES = [bool, str, float, int, list, tuple]

_logger = logging.getLogger(__name__)

# Declarative global-flag table: (short, dest, help).
_GLOBAL_PATH_FLAGS = [
    ("--d", DICOM_KEY, "path to directory storing dicom files"),
    ("--l", LOAD_KEY, "path to data directory to load from"),
    ("--s", SAVE_KEY, "path to data directory to save to. Default: L/D"),
]


def _signature(fn):
    """Signature with string annotations evaluated (scan modules use
    ``from __future__ import annotations``)."""
    return inspect.signature(fn, eval_str=True)


def _is_tissue_annotation(ann) -> bool:
    """True for ``Tissue`` or any Union/Sequence annotation built from it
    (e.g. ``Union[Tissue, Sequence[Tissue]]`` on multi-tissue segment)."""
    import typing

    if ann is Tissue:
        return True
    return any(_is_tissue_annotation(a) for a in typing.get_args(ann))


# ======================================================================
# Scan container
# ======================================================================
class CommandLineScanContainer:
    """CLI wrapper around a scan: loads from dicoms or saved data, proxies
    attribute access, and passes num_workers/verbose/show_pbar to the
    scan's methods that take them."""

    def __init__(
        self,
        scan_type: type,
        dicom_path,
        load_path,
        ignore_ext: bool = False,
        group_by=None,
        num_workers=0,
        device_load: bool = False,
        **kwargs,
    ):
        self.scan_type = scan_type

        dicom_exists = dicom_path is not None and os.path.isdir(dicom_path)
        if dicom_path is not None and not dicom_exists:
            if load_path is None:
                raise NotADirectoryError(f"{dicom_path} is not a directory")
            warnings.warn(
                f"Dicom_path {dicom_path} not found. Will load data from {load_path}"
            )

        if dicom_exists:
            # Fresh start from dicoms; load_path is ignored.
            self.scan = scan_type.from_dicom(
                dicom_path,
                group_by=group_by or scan_type.__DEFAULT_SPLIT_BY__,
                ignore_ext=ignore_ext,
                num_workers=num_workers,
                # Pinned prefetch onto the default device: the copy of one
                # echo overlaps the parse of the next.
                to_device=True if device_load else None,
            )
        else:
            self.scan = self.load(load_path, num_workers=num_workers)

        self.generic_args = {
            "num_workers": num_workers,
            "max_workers": num_workers,
            "verbose": True,
            "show_pbar": True,
        }

    def __getattr__(self, name):
        attr = getattr(self.scan, name)
        if callable(attr):
            accepted = inspect.signature(attr).parameters.keys()
            injected = {k: self.generic_args[k] for k in accepted & self.generic_args.keys()}
            if injected:
                attr = functools.partial(attr, **injected)
        return attr

    def load(self, path: str, num_workers: int = 0):
        """Locate and load a saved scan (pickle file or directory)."""
        scan_type = self.scan_type
        candidates = []
        if os.path.isfile(path):
            candidates.append(path)
        elif os.path.isdir(path) and scan_type.NAME:
            fname = f"{scan_type.NAME}.data"
            candidates.append(os.path.join(path, fname))
            candidates.append(os.path.join(self._save_dir(path, create_dir=False), fname))
        for candidate in candidates:
            if os.path.isfile(candidate):
                return scan_type.load(candidate, num_workers)
        raise ValueError(f"Cannot load {scan_type.__name__} data from path '{path}'")

    def _save_dir(self, dir_path: str, create_dir: bool = True):
        """``dir_path/NAME`` (idempotent when dir_path already ends in NAME)."""
        name = self.scan_type.NAME
        suffix_window = dir_path[-(len(name) + 2):]
        scan_dirpath = dir_path if name in suffix_window else os.path.join(dir_path, name)
        if create_dir:
            os.makedirs(scan_dirpath, exist_ok=True)
        return scan_dirpath

    def save(self, path, save_custom: bool = True, image_data_format=None, num_workers: int = 0):
        path = self._save_dir(path, create_dir=True)
        return self.scan.save(path, save_custom, image_data_format, num_workers)


# ======================================================================
# Argument reflection
# ======================================================================
def get_nargs_for_basic_type(base_type: type):
    if base_type in (list, tuple):
        return "+"
    if base_type in (str, float, int):
        return 1
    return None


def extract_basic_type(param_type):
    """Basic type from ``typing`` aliases (e.g. Tuple → tuple)."""
    return param_type.__origin__


def add_base_argument(
    parser, param_name, param_type, param_default, param_help, additional_param_names=None
):
    try:
        if param_type not in BASIC_TYPES:
            param_type = extract_basic_type(param_type)
    except (AttributeError, TypeError):
        raise TypeError(f"Parameter '{param_name}' - type '{param_type}' not in BASIC_TYPES")

    has_default = param_default is not inspect._empty
    if has_default:
        param_help = f"{param_help}. Default: {param_default}"

    names = [f"--{n}" for n in (additional_param_names or [])] + [f"--{param_name}"]

    if param_type is bool:
        if not has_default:
            raise ValueError("All boolean parameters must have a default value.")
        parser.add_argument(
            *names,
            action=f"store_{str(not param_default).lower()}",
            dest=param_name,
            help=param_help,
        )
        return

    parser.add_argument(
        *names,
        nargs="?" if has_default else get_nargs_for_basic_type(param_type),
        default=param_default if has_default else None,
        dest=param_name,
        help=param_help,
        required=not has_default,
    )


def _coerce_scalar(token: str):
    """Best-effort numeric coercion for comma-separated CLI tuple elements."""
    for cast in (int, float):
        try:
            return cast(token)
        except ValueError:
            continue
    return token


def parse_basic_type(val, param_type):
    if param_type not in BASIC_TYPES:
        param_type = extract_basic_type(param_type)
    if type(val) is param_type:
        return val
    if param_type in (list, tuple):
        if val is None:
            return val
        if isinstance(val, str):
            # A single token like "0,100" (nargs='?' when the parameter has
            # a default) must split into elements — tuple("0,100") would
            # character-split it.
            parts = [p for p in val.split(",") if p != ""]
            return param_type(_coerce_scalar(p) for p in parts)
        return param_type(val)
    if type(val) is list and get_nargs_for_basic_type(param_type) == 1:
        return val[0]
    return param_type(val) if val else val


# ======================================================================
# Tissues
# ======================================================================
def add_tissues(parser: argparse.ArgumentParser):
    for tissue_cls in knee.SUPPORTED_TISSUES:
        parser.add_argument(
            f"--{tissue_cls.STR_ID}",
            action="store_const",
            default=False,
            const=True,
            help=f"analyze {tissue_cls.FULL_NAME}",
        )


def parse_tissues(vargin: dict):
    load_path = vargin[LOAD_KEY]

    def _make(tissue_cls):
        t = tissue_cls()
        if load_path:
            t.load_data(load_path)
        return t

    selected = [cls for cls in knee.SUPPORTED_TISSUES if vargin.get(cls.STR_ID)]
    if not selected:
        _logger.info("No tissues specified, computing for all supported tissues...")
        selected = knee.SUPPORTED_TISSUES

    tissues = [_make(cls) for cls in selected]
    _logger.info("Tissue(s): " + ", ".join(t.FULL_NAME for t in tissues))
    return tissues


# ======================================================================
# Segmentation handling
# ======================================================================
def add_segmentation_subparser(parser):
    parser.add_argument(
        f"--{SEGMENTATION_WEIGHTS_DIR_KEY}",
        type=str,
        nargs=1,
        required=True,
        help="path to directory with weights",
    )
    parser.add_argument(
        f"--{SEGMENTATION_MODEL_KEY}",
        choices=SUPPORTED_MODELS,
        nargs="?",
        default=None,
        help=f"built-in model to use for segmentation. Choices: {SUPPORTED_MODELS}",
    )
    parser.add_argument(
        f"--{SEGMENTATION_CONFIG_KEY}",
        type=str,
        default=None,
        help="config file for non-built-in model",
    )
    parser.add_argument(
        f"--{SEGMENTATION_BATCH_SIZE_KEY}",
        metavar="B",
        type=int,
        default=preferences.segmentation_batch_size,
        nargs="?",
        help=f"batch size for inference. Default: {preferences.segmentation_batch_size}",
    )
    return parser


def handle_segmentation(vargin, scan: ScanSequence, tissue: Tissue):
    if not vargin[SEGMENTATION_MODEL_KEY] and not vargin[SEGMENTATION_CONFIG_KEY]:
        raise ValueError(
            f"Either `--{SEGMENTATION_MODEL_KEY}` or `--{SEGMENTATION_CONFIG_KEY}` "
            f"must be specified"
        )

    weights_dir = vargin[SEGMENTATION_WEIGHTS_DIR_KEY][0]
    if isinstance(tissue, Sequence):
        weights = [t.find_weights(weights_dir) for t in tissue]
        if any(w != weights[0] for w in weights):
            raise ValueError(f"The tissues resolve to different weight files: {weights}")
        weights_path = weights[0]
    else:
        weights_path = tissue.find_weights(weights_dir)

    dims = scan.get_dimensions()
    input_shape = (dims[0], dims[1], 1)
    if vargin[SEGMENTATION_MODEL_KEY]:
        model = get_model(
            vargin[SEGMENTATION_MODEL_KEY], input_shape=input_shape, weights_path=weights_path
        )
    else:
        model = model_from_config(
            vargin[SEGMENTATION_CONFIG_KEY],
            weights_dir=weights_dir,
            input_shape=input_shape,
        )
    model.batch_size = vargin[SEGMENTATION_BATCH_SIZE_KEY]
    return model


CUSTOM_TYPE_TO_HANDLE_DICT = {SegModel: handle_segmentation}


def add_custom_argument(parser, param_type):
    if param_type is SegModel:
        add_segmentation_subparser(parser)
        return True
    return False


def _find_tissue_groups(vargin, tissues: Sequence[Tissue]):
    """Group tissues sharing one weight file (multi-class segmentation)."""
    if not isinstance(tissues, Sequence):
        if not isinstance(tissues, Tissue):
            raise TypeError(f"Expected a Tissue or a sequence of them, got {type(tissues)}")
        tissues = [tissues]
    weights_dir = vargin[SEGMENTATION_WEIGHTS_DIR_KEY][0]
    groups = defaultdict(list)
    for tissue in tissues:
        groups[tissue.find_weights(weights_dir)].append(tissue)
    return groups


# ======================================================================
# Subparser construction + dispatch
# ======================================================================
def add_scans(dosma_subparser):
    for scan in SUPPORTED_SCAN_TYPES:
        supported_actions = scan.cmd_line_actions()
        if not supported_actions:
            continue
        scan_parser = dosma_subparser.add_parser(
            scan.NAME, help=f"analyze {scan.NAME} sequence"
        )
        add_tissues(scan_parser)
        scan_subparser = scan_parser.add_subparsers(
            description=f"{scan.NAME} subcommands", dest=SCAN_ACTION_KEY
        )

        for action, wrapper in supported_actions:
            action_parser = scan_subparser.add_parser(
                wrapper.name, aliases=wrapper.aliases, help=wrapper.help
            )
            for param_name, param in _signature(action).parameters.items():
                if param_name == "self" or _is_tissue_annotation(param.annotation):
                    continue
                if param.annotation is inspect._empty:
                    raise ValueError(
                        f"scan {scan.NAME}, action {wrapper.name}, param {param_name} "
                        f"does not have an annotation. Use typing in the method declaration"
                    )
                if add_custom_argument(action_parser, param.annotation):
                    continue
                add_base_argument(
                    action_parser,
                    param_name,
                    param.annotation,
                    param.default,
                    param_help=wrapper.get_param_help(param_name),
                    additional_param_names=wrapper.get_alternative_param_names(param_name),
                )

        scan_parser.set_defaults(func=handle_scan)


def _build_params(vargin, scan, parameters, tissue=None):
    param_dict = {}
    for param_name, param in parameters.items():
        ptype = param.annotation
        if param_name == "self":
            continue
        if _is_tissue_annotation(ptype):
            if tissue is None:
                raise ValueError(f"Action parameter {param_name!r} needs a tissue")
            param_dict["tissue"] = tissue
        elif ptype in CUSTOM_TYPE_TO_HANDLE_DICT:
            param_dict[param_name] = CUSTOM_TYPE_TO_HANDLE_DICT[ptype](vargin, scan, tissue)
        else:
            param_dict[param_name] = parse_basic_type(vargin[param_name], ptype)
    return param_dict


def handle_scan(vargin):
    scan_name = vargin[SCAN_KEY]
    _logger.info(f"Analyzing {scan_name}...")
    scan_type = next(s for s in SUPPORTED_SCAN_TYPES if s.NAME == scan_name)

    scan = CommandLineScanContainer(
        scan_type,
        dicom_path=vargin[DICOM_KEY],
        load_path=vargin[LOAD_KEY],
        ignore_ext=vargin[IGNORE_EXT_KEY],
        group_by=vargin[SPLIT_BY_KEY] or None,
        num_workers=vargin[NUM_WORKERS_KEY],
        device_load=vargin.get(DEVICE_LOAD_KEY, False),
    )

    tissues = vargin[TISSUES_KEY]
    requested = vargin[SCAN_ACTION_KEY]

    action = next(
        (
            method
            for method, wrapper in scan.cmd_line_actions()
            if requested == wrapper.name or requested in wrapper.aliases
        ),
        None,
    )

    if action is None:
        scan.save(vargin[SAVE_KEY], image_data_format=preferences.image_data_format)
        return

    parameters = _signature(action).parameters
    if requested == "segment":
        for _weights, seg_tissues in _find_tissue_groups(vargin, tissues).items():
            if len(seg_tissues) == 1:
                seg_tissues = seg_tissues[0]
            getattr(scan, action.__name__)(**_build_params(vargin, scan, parameters, seg_tissues))
    elif "tissue" in parameters.keys():
        for tissue in tissues:
            getattr(scan, action.__name__)(**_build_params(vargin, scan, parameters, tissue))
    else:
        getattr(scan, action.__name__)(**_build_params(vargin, scan, parameters))

    scan.save(vargin[SAVE_KEY], image_data_format=preferences.image_data_format)
    for tissue in tissues:
        tissue.save_data(vargin[SAVE_KEY], data_format=preferences.image_data_format)

    return scan


def parse_dicom_tag_splitby(vargin_str):
    if not vargin_str:
        return vargin_str
    try:
        return ast.literal_eval(vargin_str)
    except Exception:
        return vargin_str


# ======================================================================
# Entry point
# ======================================================================
def _build_parser():
    parser = argparse.ArgumentParser(
        prog="DOSMA-TPU-TORCH",
        description="An open source MRI analysis pipeline on CUDA cards (PyTorch)",
        epilog="Either `--dicom` or `--load` must be specified. "
        "If both are given, `--dicom` will be used",
    )
    parser.add_argument(f"--{DEBUG_KEY}", action="store_true", help="use debug mode")
    for short, key, help_str in _GLOBAL_PATH_FLAGS:
        parser.add_argument(
            short, f"--{key}", metavar=key[0].upper(), type=str, default=None,
            nargs="?", dest=key, help=help_str,
        )
    parser.add_argument(
        f"--{IGNORE_EXT_KEY}", action="store_true", default=False, dest=IGNORE_EXT_KEY,
        help="ignore .dcm extension when loading dicoms. Default: False",
    )
    parser.add_argument(
        f"--{DEVICE_LOAD_KEY}", action="store_true", default=False, dest=DEVICE_LOAD_KEY,
        help="prefetch dicom volumes into card memory while parsing. Default: False",
    )
    parser.add_argument(
        f"--{SPLIT_BY_KEY}", metavar="G", type=str, default=None, nargs="?",
        dest=SPLIT_BY_KEY, help="override dicom tag to split volumes by (eg. `EchoNumbers`)",
    )
    parser.add_argument(
        f"--{GPU_KEY}", metavar="G", type=str, default=None, nargs="?", dest=GPU_KEY,
        help="gpu id: sets CUDA_VISIBLE_DEVICES, so that card is the default device. "
        "Default: None",
    )
    parser.add_argument(
        f"--{NUM_WORKERS_KEY}", metavar="G", type=int, default=0, dest=NUM_WORKERS_KEY,
        help="num cpu workers. Default: 0",
    )

    preferences_flags = preferences.cmd_line_flags()
    for flag, spec in preferences_flags.items():
        spec = dict(spec)
        spec["dest"] = flag
        aliases = spec.pop("aliases")
        spec.pop("name", None)
        parser.add_argument(*aliases, **spec)

    subparsers = parser.add_subparsers(help="sub-command help", dest=SCAN_KEY)
    add_scans(subparsers)
    knee.knee_parser(subparsers)
    return parser, preferences_flags


def parse_args(f_input=None):
    """Parse the command-line arguments (``f_input``, else ``sys.argv``)
    and run the command; returns the seconds it took."""
    parser, preferences_flags = _build_parser()

    start_time = time.time()
    if f_input:
        args = parser.parse_args(f_input)
    else:
        args = parser.parse_args()
        setup_logger(env.log_file_path())

    vargin = vars(args)
    if vargin[DEBUG_KEY]:
        env.debug(True)
    _logger.debug(vargin)

    if vargin[GPU_KEY] is not None:
        # Read when CUDA is first initialised, which nothing above has done.
        os.environ["CUDA_VISIBLE_DEVICES"] = vargin[GPU_KEY]

    for flag in preferences_flags:
        preferences.set(flag, vargin[flag])

    if not vargin[DICOM_KEY] and not vargin[LOAD_KEY]:
        raise ValueError("Must provide path to dicoms or path to load data from")

    if not vargin[SAVE_KEY]:
        vargin[SAVE_KEY] = vargin[LOAD_KEY] or f"{vargin[DICOM_KEY]}/data"
    os.makedirs(vargin[SAVE_KEY], exist_ok=True)

    vargin[TISSUES_KEY] = parse_tissues(vargin)
    vargin[SPLIT_BY_KEY] = parse_dicom_tag_splitby(vargin[SPLIT_BY_KEY])

    args.func(vargin)

    time_elapsed = time.time() - start_time
    _logger.info(f"Time Elapsed: {time_elapsed:.2f} seconds")
    return time_elapsed


if __name__ == "__main__":
    parse_args()
