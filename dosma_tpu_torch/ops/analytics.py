"""Gathers and reductions of masked voxels for regional analytics
(counterpart of ``dosma_tpu/ops/analytics.py``).

A quantitative map on a card is read by region. :func:`region_stats` gives
every region's count, mean, std and median in one chain of passes over the
map and the label mask on the map's device: the hand-written kernel
``csrc/region_stats.cu`` for a CUDA tensor (no host wait until the caller
reads the small result), :func:`region_stats_reference`, the plain PyTorch
version of the same passes, for a CPU tensor. The tissues that select
their own voxels gather them on the card with one torch index gather, and
their statistics and the per-bin means of their unrolled maps are float64
reductions on the map's device. Only statistics and the small unrolled
tables cross to the host, never the full map. (The JAX package pads the
index vector to a power of two so that XLA compiles few programs; torch
needs no such buckets.)
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dosma_tpu_torch.core.device import as_tensor
from dosma_tpu_torch.utils.profiling import count

__all__ = [
    "gather_voxels",
    "compressed_values",
    "volume_tensor",
    "flat_indices",
    "summary",
    "scatter_mean",
    "region_stats",
    "region_stats_reference",
    "region_values",
]


def gather_voxels(volume: torch.Tensor, flat_idx) -> torch.Tensor:
    """``volume.reshape(-1)[flat_idx]`` as one gather on ``volume``'s device.

    NaNs in ``volume`` pass through untouched: the caller applies its NaN
    policy to the gathered values.
    """
    flat_idx = torch.as_tensor(flat_idx, dtype=torch.int64, device=volume.device)
    return volume.reshape(-1)[flat_idx]


def flat_indices(indices, shape) -> np.ndarray:
    """Row-major flat int64 indices of the ``(iy, ix, iz)`` tuple of
    ``np.nonzero`` into a volume of ``shape``."""
    iy, ix, iz = (np.asarray(i, np.int64) for i in indices)
    _, w, s = shape
    return (iy * w + ix) * s + iz


def volume_tensor(volume) -> torch.Tensor:
    """A map's pixels as a tensor where they lie: a host array becomes a CPU
    tensor (no copy), a tensor stays on its device.

    The tissues' own gathers (``Tissue._masked_values``, which the tibial,
    patellar and meniscus rows share, and ``FemoralCartilage.quant_rows``)
    read a host map through it, so they keep it on the CPU;
    ``QuantitativeValue.metric_rows`` computes a host map on the default
    device instead."""
    return as_tensor(volume, volume.device if isinstance(volume, torch.Tensor) else "cpu")


def compressed_values(volume, indices) -> np.ndarray:
    """``volume[iy, ix, iz]`` as a float64 host vector.

    ``indices`` is the ``(iy, ix, iz)`` tuple of ``np.nonzero(mask)``. A
    numpy volume gathers on the host; a tensor gathers on its device, so
    only ``len(iy)`` values cross to the host.
    """
    iy, ix, iz = indices
    if not isinstance(volume, torch.Tensor):
        return np.asarray(volume[iy, ix, iz], dtype=np.float64)
    flat = flat_indices(indices, volume.shape)
    return gather_voxels(volume, flat).cpu().numpy().astype(np.float64)


def summary(values: torch.Tensor, fns: Optional[Dict[str, Callable]] = None) -> dict:
    """Mean / population Std / Median / # Voxels of a 1-D tensor of valid
    values, reduced in float64 on its device (the median is the mean of
    the two middle values for an even count, as ``np.nanmedian``; no
    values give NaN statistics), and each of ``fns`` on the values as a
    host array."""
    n = values.numel()
    row = {"Mean": np.nan, "Std": np.nan, "Median": np.nan}
    if n:
        v = values.to(torch.float64)
        mean = v.mean()
        std = torch.sqrt(((v - mean) ** 2).mean())
        median = torch.sort(values).values[(n - 1) // 2: n // 2 + 1].to(torch.float64).mean()
        row = dict(zip(row, torch.stack([mean, std, median]).tolist()))
    row["# Voxels"] = n
    if fns:
        host = values.cpu().numpy()
        for fname, fn in fns.items():
            row[fname] = fn(host)
    return row


def scatter_mean(keys: torch.Tensor, values: torch.Tensor, nkeys: int) -> np.ndarray:
    """The mean of ``values`` at each key in ``[0, nkeys)``, summed in
    float64 on their device, as a float64 host vector; a key with no value
    gives NaN."""
    sums = torch.zeros(nkeys, dtype=torch.float64, device=values.device)
    sums.index_add_(0, keys, values.to(torch.float64))
    counts = torch.bincount(keys, minlength=nkeys).to(torch.float64)
    return (sums / counts).cpu().numpy()


# ----------------------------------------------------------------------
# Region statistics: count, mean, std and median of every region at once
# ----------------------------------------------------------------------
_DIGIT_BITS = 11  # csrc/region_stats.cu's kDigitBits
_MAX_LABELS = 128  # csrc/region_stats.cu's kMaxLabels
# The kernel's mask codes (csrc/region_stats.cu's MaskCode); other integer
# and floating masks are widened exactly to one of these first.
_MASK_CODES = {None: 0, torch.bool: 1, torch.uint8: 1, torch.uint16: 2, torch.int16: 3,
               torch.uint32: 4, torch.int32: 5, torch.int64: 6, torch.float32: 7,
               torch.float64: 8}
_MASK_WIDEN = {torch.int8: torch.int16, torch.float16: torch.float32,
               torch.bfloat16: torch.float32}

# (lower, upper, lower closed, upper closed), or None for no bounds.
Limits = Optional[Tuple[float, float, bool, bool]]


def _limits(bounds, closed: str) -> Limits:
    if not bounds:
        return None
    if len(bounds) != 2:
        raise ValueError(f"`bounds` must be (lower, upper), got {bounds}")
    lb, ub = bounds
    if lb > ub:
        raise ValueError(f"lower:{lb}, upper: {ub}")
    if closed not in ("right", "left", "both", "neither"):
        raise ValueError(f"Invalid `closed`={closed!r}")
    return float(lb), float(ub), closed in ("left", "both"), closed in ("right", "both")


def _in_limits(values: torch.Tensor, limits: Limits) -> torch.Tensor:
    """Inside the limits, compared in the values' own type."""
    lb, ub, lower_closed, upper_closed = limits
    keep = values >= lb if lower_closed else values > lb
    return keep & (values <= ub if upper_closed else values < ub)


def _valid(values: torch.Tensor, limits: Limits) -> torch.Tensor:
    keep = torch.isfinite(values)
    return keep if limits is None else keep & _in_limits(values, limits)


def _as_label(label) -> int:
    as_int = int(label)
    if as_int != label:
        raise ValueError(f"a label must be an integer, got {label!r}")
    return as_int


def _is_label(mask_values: torch.Tensor, label: int) -> torch.Tensor:
    """``mask == label`` as the kernel tests it: an integer mask as an
    integer (a label outside its type's range matches nothing), a floating
    mask against the label in its own type."""
    if mask_values.is_floating_point():
        return mask_values == label
    info = torch.iinfo(mask_values.dtype)
    if info.min <= label <= info.max:
        return mask_values == label
    return torch.zeros(mask_values.shape, dtype=torch.bool, device=mask_values.device)


# Unsigned masks that torch cannot compare on the CPU, widened exactly.
_COMPARABLE = {torch.uint16: torch.int32, torch.uint32: torch.int64}


def _comparable(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The mask in a type the plain version computes with: booleans as
    their bytes, the unsigned types torch cannot compare widened."""
    if mask is None or mask.dtype == torch.bool:
        return mask if mask is None else mask.view(torch.uint8)
    return mask.to(_COMPARABLE.get(mask.dtype, mask.dtype))


def _prepared(volume, mask, label_values, bounds, closed):
    """The flat map (float32 or float64; other types widened exactly to
    float64), the flat mask (or None), the labels as integers and the limits."""
    limits = _limits(bounds, closed)
    labels = [_as_label(label) for label in label_values]
    if volume.dtype not in (torch.float32, torch.float64):
        volume = volume.to(torch.float64)
    volume = volume.reshape(-1)
    if mask is not None:
        if mask.numel() != volume.numel() or mask.device != volume.device:
            raise ValueError(f"the mask ({tuple(mask.shape)}, {mask.device}) does not match the "
                             f"map ({volume.numel()} voxels, {volume.device})")
        mask = mask.reshape(-1)
        mask = mask.to(_MASK_WIDEN.get(mask.dtype, mask.dtype)).contiguous()
        if mask.dtype not in _MASK_CODES:
            raise ValueError(f"region_stats takes integer, boolean or floating masks, got "
                             f"{mask.dtype}")
    return volume.contiguous(), mask, labels, limits


def region_stats(volume: torch.Tensor, mask: Optional[torch.Tensor], label_values: Sequence[int],
                 bounds=None, closed: str = "right") -> torch.Tensor:
    """Count, mean, population std and median of the valid voxels of each
    region, as a ``(len(label_values) + 1, 4)`` float64 tensor on
    ``volume``'s device: one row per label, then the total.

    Valid voxels are finite and inside ``bounds`` (``closed`` picks the
    inclusive ends; the bounds are compared in the map's type, as torch
    compares a tensor with a Python number). A label's region is every
    valid voxel whose mask value equals it; the total is every valid voxel
    with mask > 0, labels absent from ``label_values`` included (without a
    mask, every valid voxel). The median is the mean of the two middle
    values for an even count, the very elements a sort gives; mean and std
    are float64 sums. An empty region gives a count of 0 and NaN
    statistics. ``mask`` (any integer, boolean or floating type) lies on
    the map's device and has its number of voxels.

    A CUDA tensor runs the kernel chain ``csrc/region_stats.cu`` (at most
    128 labels) and the host waits for nothing; a CPU tensor runs
    :func:`region_stats_reference`.
    """
    volume, mask, labels, limits = _prepared(volume, mask, label_values, bounds, closed)
    if volume.device.type == "cuda":
        return _launch(volume, mask, labels, limits)
    if volume.device.type == "cpu":
        return _region_stats_plain(volume, mask, labels, limits)
    raise ValueError(f"region_stats runs on cpu or cuda tensors, got {volume.device}")


def region_stats_reference(volume: torch.Tensor, mask: Optional[torch.Tensor],
                           label_values: Sequence[int], bounds=None,
                           closed: str = "right") -> torch.Tensor:
    """The plain PyTorch version of :func:`region_stats`, on any device:
    the same keys, digits and histograms (``torch.bincount``), each
    selection narrowing the candidates before the next digit."""
    volume, mask, labels, limits = _prepared(volume, mask, label_values, bounds, closed)
    return _region_stats_plain(volume, mask, labels, limits)


def _digits(bits: int) -> List[Tuple[int, int]]:
    """(shift, width) of each digit of a ``bits``-bit key, most significant
    first: 11 bits each, the last one the rest."""
    out, top = [], bits
    while top > 0:
        shift = max(top - _DIGIT_BITS, 0)
        out.append((shift, top - shift))
        top = shift
    return out


def _keys(values: torch.Tensor) -> torch.Tensor:
    """Order-preserving signed keys of float32 (int32 keys) or float64
    (int64 keys) values: the bits, with every bit but the sign flipped for
    a negative value. The kernel's unsigned key is this one with its sign
    bit flipped."""
    bits = values.view(torch.int32 if values.dtype == torch.float32 else torch.int64)
    top = bits.element_size() * 8 - 1
    return bits ^ ((bits >> top) & ((1 << top) - 1))


def _key_value(key: int, dtype) -> float:
    top = 31 if dtype == torch.float32 else 63
    bits = key ^ ((1 << top) - 1) if key < 0 else key
    int_type = torch.int32 if dtype == torch.float32 else torch.int64
    return float(torch.tensor([bits], dtype=int_type).view(dtype))


def _digit(keys: torch.Tensor, shift: int, width: int) -> torch.Tensor:
    """Digit ``(key >> shift) & (2^width - 1)`` of the kernel's unsigned key."""
    if shift + width == keys.element_size() * 8:  # the top digit holds the sign bit
        return (keys >> shift) + (1 << (width - 1))
    return (keys >> shift) & ((1 << width) - 1)


def _finite(values: torch.Tensor) -> torch.Tensor:
    bits = values.view(torch.int32 if values.dtype == torch.float32 else torch.int64)
    ones = 0x7F800000 if values.dtype == torch.float32 else 0x7FF0000000000000
    return (bits & ones) != ones  # not all of the exponent's bits set


def _select(keys: torch.Tensor, rank: int, digits, chosen: dict, path: tuple) -> int:
    """The key of rank ``rank`` among ``keys`` (the candidates under the
    buckets ``path`` of the first digits), by the remaining ``digits``: at
    each digit the bucket that holds the rank, and the candidates in it.
    ``chosen`` keeps the candidates under each path, which a region's two
    ranks share while their buckets agree."""
    for shift, width in digits:
        d = _digit(keys, shift, width)
        hist = torch.bincount(d, minlength=1 << width)
        cum = torch.cumsum(hist, 0)
        b = int(torch.searchsorted(cum, rank, right=True))
        rank -= int(cum[b]) - int(hist[b])
        path += (b,)
        if path not in chosen:
            chosen[path] = keys[d == b]
        keys = chosen[path]
    return int(keys[0])


# Voxels a step of the plain version reads, for each torch thread: its
# temporaries stay in cache, and each thread keeps enough work an operation
# (on one thread 2^16 and 2^18 took the same time at config1; on eight,
# 2^16 took twice as long as 2^18 or 2^19).
_CHUNK = 1 << 16


def _chunk() -> int:
    return _CHUNK * torch.get_num_threads()


def _slot_table(mask, labels):
    """For an integer or boolean mask whose values span at most 2^16: the
    table from a value (less the lowest) to its slot times 2^11 (slot L + 1,
    not counted, for a value <= 0), and the lowest value; else None."""
    if mask is None or mask.is_floating_point() or not mask.numel():
        return None
    lowest, highest = (int(x) for x in torch.aminmax(mask))
    if highest - lowest >= 1 << 16:
        return None
    values = torch.arange(lowest, highest + 1, dtype=torch.int64)
    L = len(labels)
    slot = torch.full(values.shape, L, dtype=torch.int64)
    for i in reversed(range(L)):  # the first label that matches
        slot[values == labels[i]] = i
    slot[values <= 0] = L + 1
    return (slot << _DIGIT_BITS).to(device=mask.device, dtype=torch.int32), lowest


def _region_stats_plain(volume, mask, labels, limits) -> torch.Tensor:
    """The kernel's passes in torch, a chunk of the map at a time. A voxel's
    code is its slot (its label's index; L for another masked voxel; L + 1,
    not counted, for an invalid one) times 2^11 plus its key's first digit."""
    dev, L, nbins = volume.device, len(labels), 1 << _DIGIT_BITS
    mask = _comparable(mask)
    digits = _digits(volume.element_size() * 8)
    dump = (L + 1) * nbins
    chunk = _chunk()
    starts = range(0, max(volume.numel(), 1), chunk)
    # Pass 0: validity, the codes, the first digit's histogram by slot, the
    # sums (by code: a slot's sum is its row's).
    hist0 = torch.zeros((L + 2) * nbins, dtype=torch.int64, device=dev)
    sums = torch.zeros((L + 2) * nbins, dtype=torch.float64, device=dev)
    codes = []
    table = _slot_table(mask, labels)
    for start in starts:
        v = volume[start:start + chunk]
        keep = _finite(v)
        if limits is not None:
            keep &= _in_limits(v, limits)
        first = _digit(_keys(v), *digits[0]).to(torch.int32)
        if mask is None:
            code = first + L * nbins
        elif table is not None:
            lut, lowest = table
            m = mask[start:start + chunk]
            code = lut.index_select(0, (m - lowest if lowest else m).to(torch.int32)) + first
        else:
            m = mask[start:start + chunk]
            code = first + L * nbins
            keep &= m > 0
            for i in reversed(range(L)):  # the first label that matches
                code = torch.where(_is_label(m, labels[i]), first + i * nbins, code)
        code = torch.where(keep, code, dump)
        hist0 += torch.bincount(code, minlength=(L + 2) * nbins)
        sums += torch.bincount(code, weights=v.to(torch.float64), minlength=(L + 2) * nbins)
        codes.append(code)
    # The counts, means and the first digit's bucket of each region's ranks
    # (n-1)//2 and n//2; the total is every slot but the invalid one.
    by_slot = hist0.view(L + 2, nbins)[:L + 1]
    hists = [by_slot[g] for g in range(L)] + [by_slot.sum(0)]
    counts = [int(h.sum()) for h in hists]
    sums = sums.view(L + 2, nbins)[:L + 1].sum(1).tolist()
    means = [s / n if n else 0.0 for s, n in zip(sums[:L] + [sum(sums)], counts)]
    ranks = []
    wanted = torch.zeros(L + 2, nbins, dtype=torch.int32, device=dev)  # codes of the candidates
    for g, (hist, n) in enumerate(zip(hists, counts)):
        cum = torch.cumsum(hist, 0)
        ranks.append([])
        for rank in ((n - 1) // 2, n // 2) if n else ():
            b = int(torch.searchsorted(cum, rank, right=True))
            ranks[g].append((b, rank - (int(cum[b]) - int(hist[b]))))
            wanted[g if g < L else slice(0, L + 1), b] = 1
    wanted = wanted.view(-1)
    # Pass 1: the squared deviations (by code, as the sums), and the voxels
    # in a rank's bucket.
    code_means = torch.tensor(means[:L] + [means[L], means[L]], dtype=torch.float64,
                              device=dev).repeat_interleave(nbins)
    devs = torch.zeros((L + 2) * nbins, dtype=torch.float64, device=dev)
    total_dev = torch.zeros((L + 2) * nbins, dtype=torch.float64, device=dev)
    cand_keys, cand_codes = [], []
    for start, code in zip(starts, codes):
        v = volume[start:start + chunk]
        x = v.to(torch.float64)
        d = x - code_means.index_select(0, code)
        devs += torch.bincount(code, weights=d.mul_(d), minlength=(L + 2) * nbins)
        d = x - means[L]
        total_dev += torch.bincount(code, weights=d.mul_(d), minlength=(L + 2) * nbins)
        at = torch.nonzero(wanted.index_select(0, code)).squeeze(1)
        cand_keys.append(_keys(v[at]))
        cand_codes.append(code[at])
    cand_keys, cand_codes = torch.cat(cand_keys), torch.cat(cand_codes)
    devs = (devs.view(L + 2, nbins)[:L].sum(1).tolist()
            + [float(total_dev.view(L + 2, nbins)[:L + 1].sum())])
    rows = []
    for g, n in enumerate(counts):
        if not n:
            rows.append([0.0, math.nan, math.nan, math.nan])
            continue
        chosen, found = {}, []
        for b, rank in ranks[g]:
            if (b,) not in chosen:
                if g < L:
                    sel = cand_codes == g * nbins + b
                else:
                    sel = (cand_codes & (nbins - 1)) == b
                chosen[(b,)] = cand_keys[sel]
            found.append(_key_value(_select(chosen[(b,)], rank, digits[1:], chosen, (b,)),
                                    volume.dtype))
        a, b = found
        rows.append([float(n), means[g], math.sqrt(devs[g] / n), a if n % 2 else (a + b) / 2])
    return torch.tensor(rows, dtype=torch.float64, device=dev)


def _kernel_lib():
    from dosma_tpu_torch.ops._build import load_library

    lib = load_library("region_stats")
    fn = lib.dosma_region_stats
    if fn.argtypes is None:
        vp, ci, ll, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
        fn.argtypes = [vp, ci, vp, ci, ll, ci, vp, ci, cd, cd, ci, ci, vp, vp, vp]
        fn.restype = ci
        lib.dosma_region_stats_workspace.argtypes = [ll, ci]
        lib.dosma_region_stats_workspace.restype = ll
    return lib


def _launch(volume, mask, labels, limits) -> torch.Tensor:
    if len(labels) > _MAX_LABELS:
        raise ValueError(f"region_stats on a card takes at most {_MAX_LABELS} labels, "
                         f"got {len(labels)}")
    lib = _kernel_lib()
    n, L = volume.numel(), len(labels)
    work = torch.empty(lib.dosma_region_stats_workspace(n, L), dtype=torch.uint8,
                       device=volume.device)
    out = torch.empty((L + 1, 4), dtype=torch.float64, device=volume.device)
    lb, ub, lower_closed, upper_closed = limits or (0.0, 0.0, False, False)
    with torch.cuda.device(volume.device):
        stream = torch.cuda.current_stream().cuda_stream
        count("region_stats.launches")
        err = lib.dosma_region_stats(
            volume.data_ptr(), int(volume.dtype == torch.float64),
            None if mask is None else mask.data_ptr(), _MASK_CODES[None if mask is None
                                                                    else mask.dtype],
            n, L, (ctypes.c_longlong * max(L, 1))(*labels), int(limits is not None), lb, ub,
            int(lower_closed), int(upper_closed), work.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"region_stats kernel launch failed: {torch.cuda.get_device_name(volume.device)} "
            f"reported CUDA error {err}"
        )
    return out


def region_values(volume: torch.Tensor, mask: Optional[torch.Tensor],
                  label_values: Sequence[int], bounds=None,
                  closed: str = "right") -> List[torch.Tensor]:
    """The valid values of each region of :func:`region_stats`, in voxel
    order, on ``volume``'s device: one gather of every voxel with mask > 0,
    split by label (the caller's reductions that need the values)."""
    volume, mask, labels, limits = _prepared(volume, mask, label_values, bounds, closed)
    mask = _comparable(mask)
    if mask is None:
        return [volume[_valid(volume, limits)]]
    flat = torch.nonzero(mask > 0).squeeze(1)
    at = mask[flat]
    values = gather_voxels(volume, flat)
    keep = _valid(values, limits)
    values, at = values[keep], at[keep]
    return [values[_is_label(at, label)] for label in labels] + [values]
