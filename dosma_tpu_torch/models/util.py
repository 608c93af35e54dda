"""Model registry and config loading (counterpart of ``dosma_tpu/models/util.py``)."""

from __future__ import annotations

import os
from functools import partial
from typing import Dict, Sequence, Type

from dosma_tpu_torch.models.oaiunet2d import IWOAIOAIUnet2D, IWOAIOAIUnet2DNormalized, OAIUnet2D
from dosma_tpu_torch.models.seg_model import SegModel
from dosma_tpu_torch.models.stanford_qdess import StanfordQDessUNet2D

__all__ = ["get_model", "model_from_config", "SUPPORTED_MODELS"]


def _build_registry() -> Dict[str, Type[SegModel]]:
    registry: Dict[str, Type[SegModel]] = {}
    for cls in (OAIUnet2D, IWOAIOAIUnet2D, IWOAIOAIUnet2DNormalized, StanfordQDessUNet2D):
        registry[cls.__name__] = cls
        for alias in cls.ALIASES:
            registry[alias] = cls
    return registry


_REGISTRY = _build_registry()

# Primary aliases, exposed on the command line.
SUPPORTED_MODELS = [
    OAIUnet2D.ALIASES[0],
    IWOAIOAIUnet2D.ALIASES[0],
    IWOAIOAIUnet2DNormalized.ALIASES[0],
    StanfordQDessUNet2D.ALIASES[0],
]


def get_model(model_str: str, input_shape, weights_path, **kwargs) -> SegModel:
    """Build a model by alias or class name."""
    cls = _REGISTRY.get(model_str)
    if cls is None:
        raise LookupError(f"{model_str} model type not supported")
    return cls(input_shape, weights_path, **kwargs)


def model_from_config(cfg_file_or_dict, weights_dir: str = None, **kwargs) -> SegModel:
    """Build a model from a config with keys ``DOSMA_MODEL``, ``CATEGORIES``
    and ``WEIGHTS_FILE`` (a dict, or a yaml file: yaml is imported only
    then); ``generate_mask`` returns ``{category: mask}`` in the config's
    order."""
    if isinstance(cfg_file_or_dict, str):
        import yaml

        with open(cfg_file_or_dict) as f:
            cfg = yaml.safe_load(f)
    else:
        cfg = cfg_file_or_dict

    categories = cfg["CATEGORIES"]
    weights = cfg["WEIGHTS_FILE"]
    if not os.path.isfile(weights):
        if not weights_dir:
            raise ValueError(
                f"WEIGHTS_FILE {weights!r} is not a file; `weights_dir` must be specified"
            )
        weights = os.path.join(weights_dir, weights)

    try:
        model = get_model(cfg["DOSMA_MODEL"], weights_path=weights, force_weights=True, **kwargs)
    except LookupError as e:
        raise LookupError(f"BASE_MODEL '{cfg['DOSMA_MODEL']}' not supported \n{e}") from e

    def _remapped(inner, *args, **kw):
        out = inner(*args, **kw)
        if isinstance(out, dict):
            out = list(out.values())
        elif not isinstance(out, Sequence):
            out = [out]
        else:
            out = list(out)
        if len(categories) != len(out):
            raise ValueError(f"Got {len(out)} outputs, but {len(categories)} categories")
        return dict(zip(categories, out))

    model.generate_mask = partial(_remapped, model.generate_mask)
    return model
