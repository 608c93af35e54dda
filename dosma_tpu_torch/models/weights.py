"""U-Net weights: Keras ``.h5`` files, the port's ``.pt`` state dicts, and
the JAX package's parameter dict (counterpart of ``dosma_tpu/models/weights.py``).

The reference ships pretrained Keras weights (``model.save_weights`` HDF5
layout: root attribute ``layer_names``, one group a layer with
``weight_names``). They are read into the JAX package's nested dict with
numpy leaves, in Keras layouts:

- Conv2D kernel ``(kh, kw, in, out)`` (HWIO);
- Conv2DTranspose kernel ``(kh, kw, out, in)``;
- BatchNorm weights in the order gamma, beta, moving mean, moving variance.

:func:`state_dict_from_params` turns that dict into :class:`~dosma_tpu_torch.
models.unet2d.UNet2D`'s state dict (PyTorch layouts) and
:func:`params_from_state_dict` turns it back. A machine without h5py takes
the weights as a ``.pt`` state dict written by :func:`convert_weights`.
h5py is imported only where an ``.h5`` file is read or written.
"""

from __future__ import annotations

import os
import re
from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np
import torch

__all__ = [
    "load_keras_unet2d_weights",
    "load_unet2d_weights",
    "read_keras_h5",
    "save_keras_unet2d_weights",
    "state_dict_from_params",
    "params_from_state_dict",
    "params_checksum",
    "verify_weights",
    "convert_weights",
    "regenerate_goldens",
]


def _layer_index(name: str) -> Tuple[str, int]:
    """('conv2d_12' → ('conv2d', 12)); un-suffixed layers are index 0."""
    m = re.match(r"^(.*?)(?:_(\d+))?$", name)
    base, idx = m.group(1), m.group(2)
    return base, int(idx) if idx is not None else 0


def read_keras_h5(path: str) -> List[Tuple[str, List[np.ndarray]]]:
    """(layer_name, [weights...]) in model order from a Keras h5 file."""
    import h5py

    out = []
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        layer_names = root.attrs.get("layer_names")
        if layer_names is None:
            layer_names = list(root.keys())
        layer_names = [n.decode() if isinstance(n, bytes) else n for n in layer_names]
        for lname in layer_names:
            if lname not in root:
                continue
            g = root[lname]
            weight_names = g.attrs.get("weight_names", [])
            weight_names = [n.decode() if isinstance(n, bytes) else n for n in weight_names]
            if not weight_names:
                continue
            out.append((lname, [np.asarray(g[wn]) for wn in weight_names]))
    return out


def load_keras_unet2d_weights(path: str) -> Dict:
    """A reference U-Net ``.h5`` as the nested parameter dict (numpy leaves).

    Relies on the layer creation order (encoder convs and BNs, then decoder
    transpose convs, convs and BNs, then the 1x1 head), classifying layers
    by name; the counts of each kind are checked.
    """
    from dosma_tpu_torch.models.unet2d import DEPTH

    convs, convts, bns = [], [], []  # (idx, [weights])
    for lname, weights in read_keras_h5(path):
        _, idx = _layer_index(lname)
        if "conv2d_transpose" in lname or "deconv" in lname.lower():
            convts.append((idx, weights))
        elif "conv" in lname.lower():
            convs.append((idx, weights))
        elif "batch_normalization" in lname or lname.lower().startswith("bn"):
            bns.append((idx, weights))
    for layers in (convs, convts, bns):
        layers.sort(key=lambda t: t[0])

    expected_convs = 2 * DEPTH + 2 * (DEPTH - 1) + 1
    if len(convs) != expected_convs:
        raise ValueError(f"Expected {expected_convs} Conv2D layers in {path}, found {len(convs)}")
    if len(convts) != DEPTH - 1:
        raise ValueError(
            f"Expected {DEPTH - 1} Conv2DTranspose layers in {path}, found {len(convts)}"
        )
    if len(bns) != 2 * DEPTH - 1:
        raise ValueError(
            f"Expected {2 * DEPTH - 1} BatchNormalization layers in {path}, found {len(bns)}"
        )

    def conv_params(weights):
        w, b = weights
        return {"w": np.asarray(w), "b": np.asarray(b)}

    def bn_params(weights):
        gamma, beta, mean, var = (np.asarray(a) for a in weights)
        return {"gamma": gamma, "beta": beta, "mean": mean, "var": var}

    params = {"down": [], "up": [None] * (DEPTH - 1), "final": None}
    ci = bi = 0
    for _ in range(DEPTH):
        params["down"].append({
            "conv1": conv_params(convs[ci][1]),
            "conv2": conv_params(convs[ci + 1][1]),
            "bn": bn_params(bns[bi][1]),
        })
        ci += 2
        bi += 1
    # The decoder was created from depth - 2 down to 0.
    for ti, d in enumerate(range(DEPTH - 2, -1, -1)):
        params["up"][d] = {
            "convT": conv_params(convts[ti][1]),
            "conv1": conv_params(convs[ci][1]),
            "conv2": conv_params(convs[ci + 1][1]),
            "bn": bn_params(bns[bi][1]),
        }
        ci += 2
        bi += 1
    params["final"] = conv_params(convs[ci][1])
    return params


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def save_keras_unet2d_weights(path: str, params: Dict):
    """Write a parameter dict in the Keras h5 layout (canonical layer names)."""
    import h5py

    counters = {"conv2d": 0, "batch_normalization": 0, "conv2d_transpose": 0}
    layer_specs = []  # (layer_name, [(weight_name, array), ...])

    def name(base):
        i = counters[base]
        counters[base] += 1
        return base if i == 0 else f"{base}_{i}"

    def add_conv(p, base="conv2d"):
        n = name(base)
        layer_specs.append((n, [(f"{n}/kernel:0", _host(p["w"])), (f"{n}/bias:0", _host(p["b"]))]))

    def add_bn(p):
        n = name("batch_normalization")
        layer_specs.append((n, [
            (f"{n}/gamma:0", _host(p["gamma"])),
            (f"{n}/beta:0", _host(p["beta"])),
            (f"{n}/moving_mean:0", _host(p["mean"])),
            (f"{n}/moving_variance:0", _host(p["var"])),
        ]))

    depth = len(params["down"])
    for d in range(depth):
        add_conv(params["down"][d]["conv1"])
        add_conv(params["down"][d]["conv2"])
        add_bn(params["down"][d]["bn"])
    for d in range(depth - 2, -1, -1):
        add_conv(params["up"][d]["convT"], "conv2d_transpose")
        add_conv(params["up"][d]["conv1"])
        add_conv(params["up"][d]["conv2"])
        add_bn(params["up"][d]["bn"])
    add_conv(params["final"])

    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = np.array([s[0].encode() for s in layer_specs])
        for lname, weights in layer_specs:
            g = f.create_group(lname)
            g.attrs["weight_names"] = np.array([wn.encode() for wn, _ in weights])
            for wn, arr in weights:
                g.create_dataset(wn, data=arr)


# ----------------------------------------------------------------------
# Parameter dict <-> UNet2D state dict
# ----------------------------------------------------------------------
_BN_KEYS = ("gamma", "beta", "mean", "var")


def _kernel_to_torch(w):
    """A Keras kernel in PyTorch's layout: Conv2D HWIO → (out, in, kh, kw),
    Conv2DTranspose (kh, kw, out, in) → (in, out, kh, kw), not flipped."""
    return torch.tensor(_host(w)).permute(3, 2, 0, 1).contiguous()


def _kernel_to_keras(w: np.ndarray) -> np.ndarray:
    """The inverse of :func:`_kernel_to_torch`."""
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


def state_dict_from_params(params: Dict) -> "OrderedDict[str, torch.Tensor]":
    """:class:`UNet2D`'s state dict (CPU tensors) of a nested parameter dict
    with numpy, JAX or torch leaves."""
    sd = OrderedDict()

    def block(prefix, blk):
        for conv in ("conv1", "conv2"):
            sd[f"{prefix}.{conv}.weight"] = _kernel_to_torch(blk[conv]["w"])
            sd[f"{prefix}.{conv}.bias"] = torch.tensor(_host(blk[conv]["b"]))
        for k in _BN_KEYS:
            sd[f"{prefix}.bn.{k}"] = torch.tensor(_host(blk["bn"][k]))

    for d, blk in enumerate(params["down"]):
        block(f"down.{d}", blk)
    for d, blk in enumerate(params["up"]):
        block(f"up.{d}", blk)
        sd[f"up.{d}.convT.weight"] = _kernel_to_torch(blk["convT"]["w"])
        sd[f"up.{d}.convT.bias"] = torch.tensor(_host(blk["convT"]["b"]))
    sd["final.weight"] = _kernel_to_torch(params["final"]["w"])
    sd["final.bias"] = torch.tensor(_host(params["final"]["b"]))
    return sd


def params_from_state_dict(state_dict) -> Dict:
    """The nested parameter dict (numpy leaves, Keras layouts) of a
    :class:`UNet2D` state dict: the inverse of :func:`state_dict_from_params`."""
    sd = {k: _host(v) for k, v in state_dict.items()}
    depth = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("down."))

    def conv(prefix):
        return {"w": _kernel_to_keras(sd[f"{prefix}.weight"]), "b": sd[f"{prefix}.bias"]}

    def block(prefix):
        return {"conv1": conv(f"{prefix}.conv1"), "conv2": conv(f"{prefix}.conv2"),
                "bn": {k: sd[f"{prefix}.bn.{k}"] for k in _BN_KEYS}}

    params = {"down": [block(f"down.{d}") for d in range(depth)], "up": [], "final": None}
    for d in range(depth - 1):
        blk = block(f"up.{d}")
        blk["convT"] = conv(f"up.{d}.convT")
        params["up"].append(blk)
    params["final"] = conv("final")
    return params


def load_unet2d_weights(path: str) -> Dict:
    """A weights file as the nested parameter dict: the port's ``.pt`` state
    dict (``torch.load(weights_only=True)``), else a Keras ``.h5`` file."""
    if path.endswith(".pt"):
        return params_from_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    return load_keras_unet2d_weights(path)


# ----------------------------------------------------------------------
# The pretrained-weights kit
# ----------------------------------------------------------------------
def _leaves_with_paths(node, path=""):
    """(path, leaf) pairs with the JAX package's key strings
    (``jax.tree_util.keystr``: ``['down'][0]['bn']['beta']``)."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves_with_paths(v, f"{path}[{k!r}]")
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _leaves_with_paths(v, f"{path}[{i}]")
    else:
        yield path, node


def params_checksum(params: Dict) -> str:
    """SHA-256 over the parameter dict in sorted-path order; the same hex
    digest as ``dosma_tpu``'s for the same weights, so two files that
    decode to the same network compare equal by string."""
    import hashlib

    h = hashlib.sha256()
    for path, leaf in sorted(_leaves_with_paths(params), key=lambda t: t[0]):
        arr = np.asarray(_host(leaf), dtype=np.float32)
        h.update(path.encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def verify_weights(path: str) -> Dict:
    """Load ``path``, checksum it, and check that a save and a load give
    the same digest. Returns a report dict (also printed by :func:`main`)."""
    import tempfile

    params = load_unet2d_weights(path)
    leaves = [leaf for _, leaf in _leaves_with_paths(params)]
    digest = params_checksum(params)
    with tempfile.TemporaryDirectory() as d:
        rt = os.path.join(d, "roundtrip" + (".pt" if path.endswith(".pt") else ".h5"))
        _save(rt, params)
        rt_digest = params_checksum(load_unet2d_weights(rt))
    return {
        "path": os.path.abspath(path),
        "arrays": len(leaves),
        "parameters": sum(int(np.prod(np.shape(a))) for a in leaves),
        "num_classes": int(np.shape(params["final"]["w"])[-1]),
        "sha256": digest,
        "roundtrip_ok": bool(digest == rt_digest),
    }


def _save(path: str, params: Dict):
    if path.endswith(".pt"):
        torch.save(state_dict_from_params(params), path)
    else:
        save_keras_unet2d_weights(path, params)


def convert_weights(src: str, dst: str) -> Dict:
    """Rewrite ``src`` as ``dst``: a foreign Keras ``.h5`` (any layer naming
    the reader accepts) into the canonical layout, or, for a ``dst`` ending
    in ``.pt``, into the port's state dict. The checksum shows the
    conversion is lossless."""
    params = load_unet2d_weights(src)
    _save(dst, params)
    src_digest = params_checksum(params)
    dst_digest = params_checksum(load_unet2d_weights(dst))
    return {
        "src": os.path.abspath(src),
        "dst": os.path.abspath(dst),
        "sha256": src_digest,
        "lossless": bool(src_digest == dst_digest),
    }


_GOLDEN_MODELS = (
    # (alias/weights dir, model class, golden file, stacked classes or None)
    ("iwoai-2019-t6", "IWOAIOAIUnet2D", "test_001_V00-iwoai-2019-t6.npy",
     ("fc", "tc", "pc", "men")),
    ("iwoai-2019-t6-normalized", "IWOAIOAIUnet2DNormalized",
     "test_001_V00-iwoai-2019-t6-normalized.npy", ("fc", "tc", "pc", "men")),
    ("oai-unet2d", "OAIUnet2D", "test_001_V00-oai-unet2d-fc.npy", None),
    ("stanford-qdess-2021-unet2d", "StanfordQDessUNet2D",
     "test_001_V00-stanford-qdess.npy", ("pc", "fc", "tc", "men")),
)


def regenerate_goldens(data_path: str, overwrite: bool = False) -> Dict:
    """Regenerate the golden masks for every pretrained model whose weights
    (``.h5`` or ``.pt``) exist under ``<data_path>/weights/<alias>/``.

    The scan is ``<data_path>/datasets/oai/test_001_V00.nii.gz``; goldens
    land in ``<data_path>/datasets/oai/expected/``. Returns {golden: status}.
    """
    from dosma_tpu_torch.core.io.nifti_io import NiftiReader
    from dosma_tpu_torch.models import oaiunet2d, stanford_qdess

    scan_path = os.path.join(data_path, "datasets/oai/test_001_V00.nii.gz")
    if not os.path.isfile(scan_path):
        raise FileNotFoundError(f"fixture scan not found: {scan_path}")
    out_dir = os.path.join(data_path, "datasets/oai/expected")
    os.makedirs(out_dir, exist_ok=True)
    weights_root = os.path.join(data_path, "weights")

    scan = NiftiReader().load(scan_path)
    input_shape = (scan.volume.shape[0], scan.volume.shape[1], 1)

    report = {}
    for alias, cls_name, golden, classes in _GOLDEN_MODELS:
        wdir = os.path.join(weights_root, alias)
        wfiles = sorted(
            os.path.join(wdir, f) for f in (os.listdir(wdir) if os.path.isdir(wdir) else [])
            if f.endswith((".h5", ".pt"))
        )
        out_path = os.path.join(out_dir, golden)
        if not wfiles:
            report[golden] = "skipped (no weights)"
            continue
        if os.path.exists(out_path) and not overwrite:
            report[golden] = "exists (use --overwrite)"
            continue
        cls = getattr(oaiunet2d, cls_name, None) or getattr(stanford_qdess, cls_name)
        masks = cls(input_shape, wfiles[0]).generate_mask(scan)
        if classes is None:
            arr = np.asarray(masks.volume, dtype=np.uint8)
        else:
            arr = np.stack([np.asarray(masks[c].volume, dtype=np.uint8) for c in classes], axis=-1)
        np.save(out_path, arr)
        report[golden] = f"written {arr.shape}"
    return report


def main(argv=None):
    import argparse
    import json

    p = argparse.ArgumentParser(
        prog="python -m dosma_tpu_torch.models.weights",
        description="Pretrained-weights kit: verify/convert U-Net weights (Keras .h5, or the "
        "port's .pt state dict) and regenerate golden masks.",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    pv = sub.add_parser("verify", help="load, checksum, and round-trip a weights file")
    pv.add_argument("path")
    pc = sub.add_parser("convert", help="rewrite weights as canonical .h5, or as .pt for a "
                                        "machine without h5py")
    pc.add_argument("src")
    pc.add_argument("dst")
    pg = sub.add_parser("golden", help="regenerate golden masks for the gated parity tier")
    pg.add_argument(
        "--data", default=os.environ.get("DOSMA_UNITTEST_DATA_PATH"),
        help="unittest data dir (default: $DOSMA_UNITTEST_DATA_PATH)",
    )
    pg.add_argument("--overwrite", action="store_true")
    args = p.parse_args(argv)

    if args.cmd == "verify":
        out = verify_weights(args.path)
    elif args.cmd == "convert":
        out = convert_weights(args.src, args.dst)
    else:
        if not args.data:
            p.error("golden requires --data or DOSMA_UNITTEST_DATA_PATH")
        out = regenerate_goldens(args.data, overwrite=args.overwrite)
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
