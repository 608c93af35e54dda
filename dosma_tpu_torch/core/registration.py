"""Registration facade: ``register`` / ``apply_warp``.

Counterpart of ``dosma_tpu/core/registration.py``: chains of matrix stages
(translation, rigid, affine) and of B-spline (FFD) stages. Contracts:

- inputs are MedicalVolumes or paths (NIfTI files, DICOM series directories,
  read by ``format_io_utils.generic_load``); outputs land in
  ``output_path/moving-<idx>/`` as ``TransformParameters.<stage>.json`` and,
  unless ``save_volumes=False``, ``result.<stage>.nii.gz``;
- sequential parameter stages compose into one transform and one resample,
  with collated or per-stage output specs; a chain with a B-spline stage
  registers stage by stage, each stage on the previous stages' output;
- target and moving masks (``use_mask`` per stage);
- transform reuse through :func:`apply_warp`. Transform files keep
  ``"format": "dosma_tpu-transform-v1"`` and the keys of ``dosma_tpu``, so a
  file written by either package warps in the other.

Parameters are preset names (``"rigid"``, ``"affine"``, ``"bspline"``,
``"translation"``), the file names of ``dosma_tpu``'s YAML presets (held
here as the dicts of :data:`PRESETS`, so no yaml is needed), a user's YAML
file (yaml is imported to read it), an elastix ``.txt`` parameter file, or
a :class:`RegistrationParams`.

Volumes on the host are registered on the package's default device (the
first CUDA card unless the caller asked for the CPU) and warped volumes
come back as host arrays; tensor-backed volumes are registered on their
device and warped volumes stay there. ``symlink_elastix`` /
``unlink_elastix`` are no-op stubs: there is no external binary.
"""

from __future__ import annotations

import json
import os
import uuid
import warnings
from types import SimpleNamespace
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from dosma_tpu_torch.core.device import compute_device
from dosma_tpu_torch.core.io import format_io_utils
from dosma_tpu_torch.core.io.nifti_io import NiftiWriter
from dosma_tpu_torch.core.med_volume import MedicalVolume
from dosma_tpu_torch.ops.registration import (
    RegistrationParams,
    compose_transforms,
    register_chain,
    register_chain_batch,
    register_pair,
    register_pair_bspline,
    warp_volume,
    warp_volume_batch,
    warp_volume_chain,
)
from dosma_tpu_torch.utils import env

__all__ = [
    "register",
    "apply_warp",
    "symlink_elastix",
    "unlink_elastix",
    "RegistrationOutputSpec",
    "PRESETS",
]

MedVolOrPath = Union[MedicalVolume, str]

# Output namespace mirroring nipype's RegistrationOutputSpec fields.
RegistrationOutputSpec = SimpleNamespace

# dosma_tpu/resources/registration/*.yaml, by file name.
PRESETS: Dict[str, Dict] = {
    "parameters-rigid.yaml": dict(
        transform="rigid", metric="mi", resolutions=3, iterations=250, num_bins=32,
        num_samples=2048, learning_rate=0.02,
    ),
    "parameters-affine.yaml": dict(
        transform="affine", metric="mi", resolutions=3, iterations=250, num_bins=32,
        num_samples=2048, learning_rate=0.01,
    ),
    "parameters-bspline.yaml": dict(
        transform="bspline", metric="mi", resolutions=3, iterations=400, num_bins=32,
        num_samples=4096, learning_rate=0.01, grid_spacing_mm=32.0, bending_weight=1.0e-4,
    ),
    # Inter-scan stages: cubic B-spline metric sampling and final resample.
    "parameters-rigid-interregister.yaml": dict(
        transform="rigid", metric="mi", resolutions=3, iterations=250, num_bins=32,
        num_samples=2048, learning_rate=0.02, interp_order=3, final_interp_order=3,
    ),
    "parameters-affine-interregister.yaml": dict(
        transform="affine", metric="mi", resolutions=3, iterations=250, num_bins=32,
        num_samples=2048, learning_rate=0.01, interp_order=3, final_interp_order=3,
    ),
}
_PRESET_NAMES = {
    "rigid": "parameters-rigid.yaml",
    "affine": "parameters-affine.yaml",
    "bspline": "parameters-bspline.yaml",
}


def _load_volume(x: MedVolOrPath) -> MedicalVolume:
    if isinstance(x, MedicalVolume):
        return x
    return format_io_utils.generic_load(str(x), expected_num_volumes=1)


def _load_stage_params(path_or_name) -> RegistrationParams:
    """A stage config from a preset name, a preset's file name, a user's
    YAML file, an elastix ``.txt`` parameter file, or a RegistrationParams."""
    if isinstance(path_or_name, RegistrationParams):
        return path_or_name
    name = str(path_or_name)
    if name == "translation":
        return RegistrationParams(transform="translation")
    name = _PRESET_NAMES.get(name, name)
    if name in PRESETS and not os.path.isfile(name):
        return RegistrationParams(**PRESETS[name])
    if not os.path.isfile(name):
        raise FileNotFoundError(f"Registration parameter file not found: {name}")
    if name.endswith((".yaml", ".yml")):
        import yaml  # a user's file; the presets above need no yaml

        with open(name) as f:
            cfg = yaml.safe_load(f)
        return RegistrationParams(**cfg)
    return _parse_elastix_txt(name)


# Elastix parameter keys that are either satisfied by construction in the
# registrar or genuinely cosmetic (I/O formats, logging) — accepted
# without warning. Anything NOT here and not explicitly mapped triggers a
# "silently dropped" warning so users migrating real configs see exactly
# which knobs did not carry over.
_ELASTIX_ACCEPTED_KEYS = {
    # satisfied by construction
    "Registration",            # MultiResolutionRegistration == our level scan
    "FixedImagePyramid",       # Smoothing pyramid == ours (Shrinking warned below)
    "MovingImagePyramid",
    "Interpolator",            # metric sampling (order warned below)
    "Resampler",
    "ResampleInterpolator",
    "ImageSampler",            # RandomCoordinate == ours (Grid/Full warned below)
    "NewSamplesEveryIteration",  # "true" == ours ("false" warned below)
    "HowToCombineTransforms",  # Compose == ours
    "AutomaticParameterEstimation",  # our param scaling is always automatic
    "AutomaticScalesEstimation",
    "AutomaticTransformInitialization",
    "ASGDParameterEstimationMethod",  # ASGD-internal; our Adam+cosine analog
    "Optimizer",
    "UseDirectionCosines",     # "true" == ours (full affines); "false" warned
    "MovingImageDerivativeScales",
    "CheckNumberOfSamples",
    "RequiredRatioOfValidSamples",
    "ErodeMask",               # "false" == ours ("true" warned below)
    "ErodeFixedMask",
    "DefaultPixelValue",       # 0 == ours (nonzero warned below)
    # cosmetic / I/O
    "FixedInternalImagePixelType",
    "MovingInternalImagePixelType",
    "ResultImagePixelType",
    "ResultImageFormat",
    "WriteResultImage",
    "WriteTransformParametersEachIteration",
    "ShowExactMetricValue",
    "RandomSeed",
}

_ELASTIX_MAPPED_KEYS = {
    "Transform", "Metric", "NumberOfResolutions", "MaximumNumberOfIterations",
    "NumberOfHistogramBins", "NumberOfSpatialSamples",
    "FinalGridSpacingInPhysicalUnits", "FinalGridSpacingInVoxels",
    "ImagePyramidSchedule", "FixedImagePyramidSchedule", "MovingImagePyramidSchedule",
    "BSplineInterpolationOrder", "FinalBSplineInterpolationOrder",
}


def _parse_elastix_txt(name: str) -> RegistrationParams:
    """Parse an elastix parameter file onto a :class:`RegistrationParams`.

    Full-coverage mapping of the elastix DSL
    (the reference DOSMA's shipped elastix files):
    every key is either mapped onto the engine, accepted because the
    engine satisfies it by construction, or WARNED about — nothing
    load-bearing is silently dropped. Per-level schedules (iterations,
    samples) collapse onto the engine's uniform per-level budget via max,
    with a warning when levels differ.
    """
    cfg = {}
    with open(name) as f:
        for line in f:
            line = line.strip()
            if not line.startswith("("):
                continue
            body = line.strip("()").split("//")[0]
            parts = body.replace('"', "").split()
            if not parts:
                continue
            key, vals = parts[0], parts[1:]
            cfg[key] = vals

    dropped = []

    def _warn(msg):
        dropped.append(msg)

    # A bare "(Key)" line parses to an empty value list; every consumer
    # below indexes [0] / max / mean, so drop such keys up front (with a
    # warning when the key is one we would have mapped).
    for key in [k for k, v in cfg.items() if not v]:
        if key in _ELASTIX_MAPPED_KEYS:
            _warn(f"{key} with no values ignored")
        del cfg[key]

    tf = (cfg.get("Transform", ["AffineTransform"])[0]).lower()
    if "euler" in tf or "rigid" in tf:
        transform = "rigid"
    elif "translation" in tf:
        transform = "translation"
    elif "bspline" in tf:
        transform = "bspline"
    elif "affine" in tf or "similarity" in tf:
        transform = "affine"
    else:
        _warn(f"Transform {cfg['Transform'][0]!r} approximated by 'affine'")
        transform = "affine"
    kwargs = {"transform": transform}

    if transform == "bspline" and "FinalGridSpacingInPhysicalUnits" in cfg:
        spac = [float(v) for v in cfg["FinalGridSpacingInPhysicalUnits"]]
        if len(set(spac)) > 1:
            _warn(
                f"anisotropic FinalGridSpacingInPhysicalUnits {spac} "
                f"collapsed to mean {np.mean(spac):g} mm"
            )
        kwargs["grid_spacing_mm"] = float(np.mean(spac))
    if transform == "bspline" and "FinalGridSpacingInVoxels" in cfg:
        gsv = [float(v) for v in cfg["FinalGridSpacingInVoxels"]]
        if len(gsv) not in (1, 3):
            # elastix accepts 1 or n-dim values; anything else is a
            # malformed line — collapse to the mean rather than crash in
            # make_control_grid's (3,) broadcast.
            _warn(
                f"FinalGridSpacingInVoxels with {len(gsv)} values "
                f"(expected 1 or 3) collapsed to mean {np.mean(gsv):g}"
            )
            gsv = [float(np.mean(gsv))]
        kwargs["grid_spacing_vox"] = tuple(gsv)
        if "FinalGridSpacingInPhysicalUnits" in cfg:
            _warn(
                "both FinalGridSpacingInVoxels and ...InPhysicalUnits "
                "present (mutually exclusive in elastix); voxel units "
                "take precedence"
            )
    if "NumberOfResolutions" in cfg:
        kwargs["resolutions"] = int(float(cfg["NumberOfResolutions"][0]))
    if "MaximumNumberOfIterations" in cfg:
        its = [min(int(float(v)), 1000) for v in cfg["MaximumNumberOfIterations"]]
        if len(set(its)) > 1:
            if transform == "bspline":
                # The multi-grid FFD chain honors true per-level budgets.
                kwargs["iteration_schedule"] = tuple(its)
            else:
                _warn(f"per-level iteration schedule {its} collapsed to max")
        kwargs["iterations"] = max(its)
    if "NumberOfHistogramBins" in cfg:
        kwargs["num_bins"] = int(float(cfg["NumberOfHistogramBins"][0]))
    if "NumberOfSpatialSamples" in cfg:
        ns = [int(float(v)) for v in cfg["NumberOfSpatialSamples"]]
        if len(set(ns)) > 1:
            if transform == "bspline":
                kwargs["sample_schedule"] = tuple(ns)
            else:
                _warn(f"per-level sample schedule {ns} collapsed to max")
        kwargs["num_samples"] = max(ns)

    # Pyramid shrink schedule: elastix lists per-level x/y/z factors,
    # coarsest first. Our smoothing pyramid is isotropic — per-level
    # factors collapse to their mean (sigma = factor/2).
    sched_key = next(
        (
            k
            for k in (
                "ImagePyramidSchedule",
                "FixedImagePyramidSchedule",
                "MovingImagePyramidSchedule",
            )
            if k in cfg
        ),
        None,
    )
    if (
        "MovingImagePyramidSchedule" in cfg
        and sched_key != "MovingImagePyramidSchedule"
        and cfg["MovingImagePyramidSchedule"] != cfg[sched_key]
    ):
        _warn(
            "separate MovingImagePyramidSchedule unsupported; "
            "the fixed schedule applies to both images"
        )
    if sched_key:
        vals = [float(v) for v in cfg[sched_key]]
        if vals and len(vals) % 3 == 0:
            levels = [tuple(vals[i : i + 3]) for i in range(0, len(vals), 3)]
            if any(len(set(lv)) > 1 for lv in levels):
                _warn(f"anisotropic {sched_key} {levels} collapsed to per-level means")
            kwargs["pyramid_schedule"] = tuple(float(np.mean(lv)) for lv in levels)
            kwargs["resolutions"] = len(levels)
        else:
            _warn(f"{sched_key} with {len(vals)} values is not 3/level; ignored")

    metric = (cfg.get("Metric", ["AdvancedMattesMutualInformation"])[0]).lower()
    if len(cfg.get("Metric", [""])) > 1:
        _warn(f"multi-metric {cfg['Metric']} uses only the first metric")
    kwargs["metric"] = "mse" if "squareddifference" in metric else (
        "ncc" if "correlation" in metric else "mi"
    )

    # Keys the engine satisfies only for their default/common values.
    def _is_true(key, default="true"):
        return cfg.get(key, [default])[0].lower() == "true"

    if "ImageSampler" in cfg and cfg["ImageSampler"][0].lower() not in (
        "randomcoordinate", "random", "randomsparsemask",
    ):
        _warn(
            f"ImageSampler {cfg['ImageSampler'][0]!r} unsupported; "
            "using RandomCoordinate"
        )
    if not _is_true("NewSamplesEveryIteration"):
        _warn("NewSamplesEveryIteration=false unsupported; samples are redrawn")
    if cfg.get("HowToCombineTransforms", ["Compose"])[0].lower() != "compose":
        _warn("HowToCombineTransforms != Compose unsupported; transforms compose")
    if _is_true("ErodeMask", "false") or _is_true("ErodeFixedMask", "false"):
        _warn("ErodeMask=true unsupported; masks are used un-eroded")
    if not _is_true("UseDirectionCosines"):
        _warn("UseDirectionCosines=false unsupported; direction cosines always apply")
    if float(cfg.get("DefaultPixelValue", ["0"])[0]) != 0.0:
        _warn("nonzero DefaultPixelValue unsupported; out-of-volume samples are 0")
    for pk in ("FixedImagePyramid", "MovingImagePyramid"):
        if "shrinking" in cfg.get(pk, [""])[0].lower():
            _warn(f"{pk}=Shrinking approximated by the smoothing pyramid")
    # Image interpolation orders. Metric sampling supports 1 (trilinear)
    # and 3 (cubic B-spline, prefiltered per pyramid level); the final
    # resample supports 0/1/3. Unsupported spline orders (2, 4, 5) round
    # to the nearest supported order with a warning.
    def _order(key, default, supported):
        o = int(float(cfg.get(key, [str(default)])[0]))
        if o in supported:
            return o
        near = min(supported, key=lambda s: (abs(s - o), -s))
        _warn(f"{key}={o} unsupported; using order {near}")
        return near

    if "BSplineInterpolationOrder" in cfg:
        kwargs["interp_order"] = _order("BSplineInterpolationOrder", 1, (1, 3))
    if "FinalBSplineInterpolationOrder" in cfg:
        kwargs["final_interp_order"] = _order(
            "FinalBSplineInterpolationOrder", 3, (0, 1, 3)
        )

    unknown = sorted(set(cfg) - _ELASTIX_ACCEPTED_KEYS - _ELASTIX_MAPPED_KEYS)
    if unknown:
        _warn(f"unmapped elastix keys ignored: {unknown}")

    if dropped:
        warnings.warn(
            f"elastix parameter file {os.path.basename(name)}: "
            + "; ".join(dropped),
            stacklevel=3,
        )
    return RegistrationParams(**kwargs)


def _save_transform_file(path: str, stage, stage_cfg: RegistrationParams,
                         fixed: MedicalVolume, moving: MedicalVolume):
    """Write one stage transform file. ``stage`` is ("matrix", M) or
    ("bspline", ctrl, spacing_vox)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    data = {
        "format": "dosma_tpu-transform-v1",
        "transform": stage_cfg.transform,
        "fixed_affine": np.asarray(fixed.affine).tolist(),
        "fixed_shape": list(fixed.shape[:3]),
        "moving_affine": np.asarray(moving.affine).tolist(),
        # transformix semantics: the resample order travels with the
        # transform file (FinalBSplineInterpolationOrder).
        "final_interp_order": int(stage_cfg.final_interp_order),
    }
    if stage[0] == "matrix":
        data["matrix"] = np.asarray(stage[1]).tolist()
    else:
        data["ctrl"] = np.asarray(stage[1]).tolist()
        data["spacing_vox"] = np.asarray(stage[2]).tolist()
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def _load_transform_file(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def _stage_from_tdata(tdata: Dict):
    if "matrix" in tdata:
        return ("matrix", np.asarray(tdata["matrix"]))
    return ("bspline", np.asarray(tdata["ctrl"], np.float32), np.asarray(tdata["spacing_vox"]))


def register(
    target: MedVolOrPath,
    moving: Union[MedVolOrPath, Sequence[MedVolOrPath]],
    parameters: Union[str, Sequence[str]],
    output_path: str = None,
    target_mask: MedVolOrPath = None,
    moving_masks: Union[MedVolOrPath, Sequence[MedVolOrPath]] = None,
    sequential: bool = True,
    collate: bool = True,
    num_workers: int = 0,
    num_threads: int = 1,
    show_pbar: bool = False,
    return_volumes: bool = False,
    rtype: type = dict,
    use_mask: Sequence[bool] = None,
    save_volumes: bool = True,
    **kwargs,
):
    """Register moving image(s) to the target.

    ``parameters``: see the module docstring; several run as sequential
    stages whose transforms compose. Every stage and the final warp of each
    moving image run on the compute device; a matrix-only chain's final warp
    is one launch of the warp kernel, a chain with a B-spline stage samples
    through the point samplers. ``save_volumes=False`` skips writing
    ``result.*.nii.gz`` (transform files are always written), so nothing
    but 4x4 matrices comes back to the host unless ``return_volumes`` asks
    for host-backed volumes. ``num_workers``, ``num_threads`` and
    ``show_pbar`` are accepted for API compatibility and do nothing.
    """
    assert issubclass(rtype, (dict, tuple, list)), "`rtype` must be dict or tuple"
    if not output_path:
        output_path = os.path.join(env.temp_dir(), f"register-{uuid.uuid1()}-{uuid.uuid4()}")
    os.makedirs(output_path, exist_ok=True)

    single_moving = isinstance(moving, (MedicalVolume, str, os.PathLike))
    moving = [moving] if single_moving else list(moving)
    if moving_masks is None or isinstance(moving_masks, (MedicalVolume, str, os.PathLike)):
        moving_masks = [moving_masks]
    if len(moving_masks) > 1 and len(moving) != len(moving_masks):
        raise ValueError(f"Got {len(moving)} moving images but {len(moving_masks)} moving masks")

    parameters = (
        [parameters] if isinstance(parameters, (str, RegistrationParams)) else list(parameters)
    )
    stage_cfgs = [_load_stage_params(p) for p in parameters]
    if use_mask is not None:
        if len(use_mask) != len(parameters):
            raise ValueError("`use_mask` must have the same length as `parameters`")
    else:
        any_mask = target_mask is not None or any(m is not None for m in moving_masks)
        use_mask = [any_mask] * len(parameters)

    target_mv = _load_volume(target)
    target_mask_mv = _load_volume(target_mask) if target_mask is not None else None
    moving_mvs = [_load_volume(m) for m in moving]
    moving_mask_mvs = [_load_volume(m) if m is not None else None for m in moving_masks]
    if len(moving_mask_mvs) == 1 and len(moving_mvs) > 1:
        moving_mask_mvs = moving_mask_mvs * len(moving_mvs)

    matrix_only = all(cfg.transform != "bspline" for cfg in stage_cfgs)
    run = _register_matrix_chains if matrix_only else _register_sequential_fallback
    outputs, volumes = run(
        target_mv, target_mask_mv, moving_mvs, moving_mask_mvs, stage_cfgs,
        use_mask, output_path, sequential, collate, return_volumes, save_volumes,
    )
    if issubclass(rtype, dict):
        result = {"outputs": outputs}
        if return_volumes:
            result["volumes"] = volumes
        return result
    return (outputs, volumes if return_volumes else None)


def _collate_outputs(stage_cfgs, transform_paths, warped_files, stage_outputs,
                     sequential, collate):
    # Reference contract (ref ``registration.py:438-449``): sequential=False
    # hands ALL parameter files to ONE elastix invocation (which chains them
    # internally) and returns a single spec; sequential=True returns per-stage
    # specs unless collate merges them.
    if (not sequential) or collate or len(stage_cfgs) == 1:
        return RegistrationOutputSpec(
            transform=transform_paths,
            warped_file=warped_files[-1] if warped_files else None,
            warped_files=warped_files,
        )
    return stage_outputs


def _on(volume, device) -> torch.Tensor:
    """A volume's pixels as a float32 tensor on ``device``."""
    if isinstance(volume, torch.Tensor):
        return volume.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(volume, dtype=np.float32)).to(device)


def _register_matrix_chains(
    target_mv, target_mask_mv, moving_mvs, moving_mask_mvs, stage_cfgs,
    use_mask, output_path, sequential, collate, return_volumes, save_volumes,
):
    """Registration of matrix-only chains on the compute device.

    One chain per moving image (or, for same-grid unmasked images, the
    chains in turn and one warp launch for the whole stack); the host sees
    4x4 matrices, and volumes only where files or host volumes are asked
    for.
    """
    fixed_affine = target_mv.affine
    fixed_shape = tuple(int(s) for s in target_mv.shape[:3])
    host = all(not isinstance(mv.volume, torch.Tensor) for mv in [target_mv, *moving_mvs])
    dev = compute_device(target_mv.volume, *(mv.volume for mv in moving_mvs))
    fixed = _on(target_mv.volume, dev)
    mask = (_on(target_mask_mv.reformat_as(target_mv).volume, dev)
            if target_mask_mv is not None else None)

    batchable = (
        len(moving_mvs) > 1
        and all(m is None for m in moving_mask_mvs)
        and all(tuple(m.shape[:3]) == tuple(moving_mvs[0].shape[:3]) for m in moving_mvs)
        and all(np.allclose(m.affine, moving_mvs[0].affine) for m in moving_mvs)
    )

    results = []  # per image: (cumulative stage matrices, warped tensor)
    if batchable:
        m_stack = torch.stack([_on(m.volume, dev) for m in moving_mvs])
        Ms_all, warped_stack, _info = register_chain_batch(
            fixed, fixed_affine, m_stack, moving_mvs[0].affine,
            stage_cfgs, fixed_mask=mask, use_mask=use_mask,
        )
        for i in range(len(moving_mvs)):
            results.append((list(Ms_all[i]), warped_stack[i]))
    else:
        for mv, mmask in zip(moving_mvs, moving_mask_mvs):
            mmask_arr = _on(mmask.reformat_as(mv).volume, dev) if mmask is not None else None
            Ms, warped, _extras, _info = register_chain(
                fixed, fixed_affine, _on(mv.volume, dev), mv.affine, stage_cfgs,
                fixed_mask=mask, moving_mask=mmask_arr, use_mask=use_mask,
            )
            results.append((Ms, warped))

    outputs, volumes = [], []
    for idx, ((Ms, warped), moving_mv) in enumerate(zip(results, moving_mvs)):
        reg_dir = os.path.join(output_path, f"moving-{idx}")
        os.makedirs(reg_dir, exist_ok=True)
        transform_paths, warped_files, stage_outputs = [], [], []
        n_stages = len(stage_cfgs)
        for s_idx, cfg in enumerate(stage_cfgs):
            # Incremental stage matrix: composing the stage files gives the
            # cumulative map back (the apply_warp contract).
            S = Ms[s_idx] if s_idx == 0 else np.linalg.inv(Ms[s_idx - 1]) @ Ms[s_idx]
            tpath = os.path.join(reg_dir, f"TransformParameters.{s_idx}.json")
            _save_transform_file(tpath, ("matrix", S), cfg, target_mv, moving_mv)
            transform_paths.append(tpath)

            wf = None
            if save_volumes:
                if s_idx == n_stages - 1:
                    stage_warped = warped
                else:
                    stage_warped = warp_volume(
                        _on(moving_mv.volume, dev), Ms[s_idx], fixed_affine,
                        moving_mv.affine, fixed_shape, order=int(cfg.final_interp_order),
                    )
                wf = os.path.join(reg_dir, f"result.{s_idx}.nii.gz")
                NiftiWriter().save(MedicalVolume(stage_warped.cpu().numpy(), fixed_affine), wf)
                warped_files.append(wf)
            stage_outputs.append(
                RegistrationOutputSpec(transform=[tpath], warped_file=wf,
                                       warped_files=[wf] if wf else [])
            )

        outputs.append(
            _collate_outputs(stage_cfgs, transform_paths, warped_files,
                             stage_outputs, sequential, collate)
        )
        if return_volumes:
            volumes.append(MedicalVolume(warped.cpu().numpy() if host else warped, fixed_affine))
    return outputs, volumes


def _register_sequential_fallback(
    target_mv, target_mask_mv, moving_mvs, moving_mask_mvs, stage_cfgs,
    use_mask, output_path, sequential, collate, return_volumes, save_volumes,
):
    """Stage-by-stage registration of chains with a B-spline stage, on the
    compute device.

    Each stage after the first registers the previous stages' warped image
    (on the fixed grid), and a moving mask goes through the same chain. The
    full-grid warp of a stage runs only when something takes it: the next
    stage, a result file (``save_volumes``) or, for the last stage, the
    returned volumes.
    """
    fixed_affine = target_mv.affine
    fixed_shape = tuple(int(s) for s in target_mv.shape[:3])
    host = all(not isinstance(mv.volume, torch.Tensor) for mv in [target_mv, *moving_mvs])
    dev = compute_device(target_mv.volume, *(mv.volume for mv in moving_mvs))
    fixed = _on(target_mv.volume, dev)
    tmask = (_on(target_mask_mv.reformat_as(target_mv).volume, dev)
             if target_mask_mv is not None else None)

    outputs, volumes = [], []
    for idx, moving_mv in enumerate(moving_mvs):
        moving = _on(moving_mv.volume, dev)
        moving_affine = moving_mv.affine
        reg_dir = os.path.join(output_path, f"moving-{idx}")
        os.makedirs(reg_dir, exist_ok=True)
        moving_mask_mv = moving_mask_mvs[idx] if idx < len(moving_mask_mvs) else None
        mmask0 = (_on(moving_mask_mv.reformat_as(moving_mv).volume, dev)
                  if moving_mask_mv is not None else None)

        stages, transform_paths, warped_files, stage_outputs = [], [], [], []
        warped = None
        for s_idx, cfg in enumerate(stage_cfgs):
            mask = tmask if use_mask[s_idx] else None
            mmask = mmask0 if use_mask[s_idx] else None
            if stages:
                cur_moving, cur_affine = warped, fixed_affine
                if mmask is not None:
                    # The mask lies on the original moving grid: it goes
                    # through the same chain as the image.
                    mmask = warp_volume_chain(mmask, stages, fixed_affine, moving_affine,
                                              fixed_shape)
            else:
                cur_moving, cur_affine = moving, moving_affine

            if cfg.transform == "bspline":
                ctrl, spacing_vox, _info = register_pair_bspline(
                    fixed, fixed_affine, cur_moving, cur_affine, cfg,
                    fixed_mask=mask, moving_mask=mmask,
                )
                stages.append(("bspline", ctrl, spacing_vox))
            else:
                M, _theta, _info = register_pair(
                    fixed, fixed_affine, cur_moving, cur_affine, cfg,
                    fixed_mask=mask, moving_mask=mmask,
                )
                stages.append(("matrix", M))

            tpath = os.path.join(reg_dir, f"TransformParameters.{s_idx}.json")
            _save_transform_file(tpath, stages[-1], cfg, target_mv, moving_mv)
            transform_paths.append(tpath)

            last = s_idx == len(stage_cfgs) - 1
            if (not last) or save_volumes or return_volumes:
                warped = warp_volume_chain(moving, stages, fixed_affine, moving_affine,
                                           fixed_shape, order=int(cfg.final_interp_order))
            wpath = None
            if save_volumes:
                wpath = os.path.join(reg_dir, f"result.{s_idx}.nii.gz")
                NiftiWriter().save(MedicalVolume(warped.cpu().numpy(), fixed_affine), wpath)
                warped_files.append(wpath)
            stage_outputs.append(
                RegistrationOutputSpec(transform=[tpath], warped_file=wpath,
                                       warped_files=[wpath] if wpath else [])
            )

        outputs.append(
            _collate_outputs(stage_cfgs, transform_paths, warped_files,
                             stage_outputs, sequential, collate)
        )
        if return_volumes:
            volumes.append(MedicalVolume(warped.cpu().numpy() if host else warped, fixed_affine))
    return outputs, volumes


def _apply_warp_single(moving: MedVolOrPath, transform, output_path: Optional[str],
                       rtype: type):
    moving_mv = _load_volume(moving)
    transform = [transform] if isinstance(transform, (str, os.PathLike)) else list(transform)
    tdata = [_load_transform_file(str(t)) for t in transform]

    fixed_affine = np.asarray(tdata[0]["fixed_affine"])
    fixed_shape = tuple(tdata[0]["fixed_shape"])
    stages = [_stage_from_tdata(t) for t in tdata]
    # The LAST stage's file governs the resample order (transformix reads the
    # final parameter file's FinalBSplineInterpolationOrder); files without
    # the key warp trilinear.
    order = int(tdata[-1].get("final_interp_order", 1))
    volume = moving_mv.volume
    if not isinstance(volume, torch.Tensor):
        volume = np.asarray(volume, np.float32)
    warped = warp_volume_chain(volume, stages, fixed_affine, moving_mv.affine, fixed_shape,
                               order=order)
    out_mv = MedicalVolume(warped, fixed_affine)

    if output_path:
        os.makedirs(output_path, exist_ok=True)
        out_file = os.path.join(output_path, "result.nii.gz")
        NiftiWriter().save(out_mv, out_file)
        if rtype is str:
            return out_file
    elif rtype is str:
        raise ValueError("`output_path` must be specified when rtype=str")
    return out_mv


def apply_warp(
    moving: Union[MedVolOrPath, Sequence[MedVolOrPath]],
    transform: Union[str, Sequence[str]] = None,
    out_registration: RegistrationOutputSpec = None,
    output_path: Union[str, Sequence[str]] = None,
    rtype: type = MedicalVolume,
    num_threads: int = 1,
    show_pbar: bool = False,
    num_workers: int = 0,
):
    """Apply a chain of transform files to moving image(s).

    Host volumes are warped on the default device and come back host-backed;
    tensor volumes stay on their device. Several same-grid volumes under
    matrix transforms, with no output paths, warp as one stack in one
    kernel launch.
    """
    if transform is None:
        if out_registration is None:
            raise ValueError("Either `transform` or `out_registration` must be specified")
        transform = out_registration.transform

    if isinstance(moving, (MedicalVolume, str, os.PathLike)):
        return _apply_warp_single(moving, transform, output_path, rtype)

    num_volumes = len(moving)
    seq_type = type(moving)
    if not output_path:
        output_path = [None] * num_volumes
    elif isinstance(output_path, (str, os.PathLike)):
        output_path = [os.path.join(output_path, f"image-{idx}") for idx in range(num_volumes)]
    elif not isinstance(output_path, Sequence) or len(output_path) != num_volumes:
        raise ValueError(
            "`output_path` must be a directory or list of directories of same length as `moving`"
        )

    # Same-grid matrix-only chains warp the whole stack at once. The cheap
    # tests (rtype, output paths, transform kinds) come before any volume
    # is loaded, so no volume is read twice.
    fast_eligible = (
        num_volumes > 1
        and rtype is MedicalVolume
        and all(output_path[i] is None for i in range(num_volumes))
    )
    if fast_eligible:
        transform_list = (
            [transform] if isinstance(transform, (str, os.PathLike)) else list(transform)
        )
        tdata = [_load_transform_file(str(t)) for t in transform_list]
        fast_eligible = all("matrix" in t for t in tdata)
    if fast_eligible:
        moving_mvs = [_load_volume(m) for m in moving]
        if all(
            tuple(m.shape[:3]) == tuple(moving_mvs[0].shape[:3])
            and np.allclose(m.affine, moving_mvs[0].affine)
            for m in moving_mvs
        ):
            fixed_affine = np.asarray(tdata[0]["fixed_affine"])
            fixed_shape = tuple(tdata[0]["fixed_shape"])
            order = int(tdata[-1].get("final_interp_order", 1))
            M = compose_transforms([np.asarray(t["matrix"]) for t in tdata])
            if any(isinstance(m.volume, torch.Tensor) for m in moving_mvs):
                dev = compute_device(*(m.volume for m in moving_mvs))
                stack = torch.stack([_on(m.volume, dev) for m in moving_mvs])
            else:
                stack = np.stack([np.asarray(m.volume, np.float32) for m in moving_mvs])
            warped = warp_volume_batch(stack, M, fixed_affine, moving_mvs[0].affine,
                                       fixed_shape, order=order)
            return seq_type(MedicalVolume(warped[i], fixed_affine) for i in range(num_volumes))
        # Heterogeneous grids: reuse the loaded volumes below.
        moving = moving_mvs

    out = [
        _apply_warp_single(mvg, transform, out_path, rtype)
        for mvg, out_path in zip(moving, output_path)
    ]
    return seq_type(out)


def symlink_elastix(path: str = None, lib_only: bool = True, force: bool = False):
    """No-op: registration runs in-process; there is no elastix binary to link."""
    warnings.warn("symlink_elastix is a no-op in dosma_tpu_torch - registration runs in-process.")


def unlink_elastix():
    """No-op counterpart of :func:`symlink_elastix`."""
    warnings.warn("unlink_elastix is a no-op in dosma_tpu_torch - registration runs in-process.")
