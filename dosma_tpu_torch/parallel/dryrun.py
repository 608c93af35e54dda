"""Multi-rank dry run of the port (counterpart of ``__graft_entry__.py::
dryrun_multichip``), and the launcher that starts a world of ranks.

    python -m dosma_tpu_torch.parallel.dryrun --ranks 4 --backend gloo
    python -m dosma_tpu_torch.parallel.dryrun --ranks 1 --backend nccl

spawns ``--ranks`` processes (gloo: each on the CPU, one thread; nccl: rank
r on ``cuda:r``), joins them in one process group and runs, at the JAX dry
run's tiny shapes, its five flows on one mesh: a sharded train step, a
sharded fit over an uneven voxel count, sharded inference over an uneven
slice count, the sharded qDESS flow (a DICOM series placed sharded over
slices, a sharded T2 map, femoral cartilage's 18 rows) and a sharded
registration. Rank 0 prints one ``dryrun_multichip OK: ...`` line.
"""

from __future__ import annotations

import argparse
import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["launch", "dryrun_multichip"]


def _rank_main(rank, world, backend, init_file, fn, args, results, timeout_s):
    os.environ["LOCAL_RANK"] = str(rank)
    try:
        from dosma_tpu_torch.core.device import set_default_device

        if backend == "nccl":
            torch.cuda.set_device(rank)
            set_default_device(f"cuda:{rank}")
        else:
            torch.set_num_threads(1)
            set_default_device("cpu")
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=timeout_s),
                                device_id=torch.device("cuda", rank) if backend == "nccl" else None)
        results.put((rank, True, fn(*args)))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, ranks: int, backend: str = "gloo", args: Sequence = (),
           timeout: float = 300.0) -> list:
    """Run ``fn(*args)`` on every rank of a new world of ``ranks`` processes
    and return each rank's result, in rank order.

    ``fn`` must be importable (a module-level function). Ranks join with a
    ``file://`` rendezvous in a temporary directory (no port to race for).
    A rank that raises, or a world that does not finish within ``timeout``
    seconds (a hung collective), raises here; every process is stopped.
    """
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="dosma_world_")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, ranks, backend, os.path.join(tmp, "rendezvous"), fn,
                               tuple(args), results, timeout))
             for r in range(ranks)]
    out = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(out) < ranks:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode is not None and r not in out]
                if dead:
                    raise RuntimeError(f"ranks {dead} of {ranks} exited without a result "
                                       f"(exit codes {[procs[r].exitcode for r in dead]})")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"a world of {ranks} ranks did not finish in {timeout} s; "
                                       f"ranks {sorted(out)} reported") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {ranks} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(ranks)]


# ----------------------------------------------------------------------
# The dry run's flows
# ----------------------------------------------------------------------
QDESS_T2 = dict(suppress_fat=False, tr=25.0, te=6.0, alpha=20.0, gl_area=3132.0, tg=1560.0,
                t1=1200.0)


def series_headers(shape, spacing, echo_times) -> np.ndarray:
    """(1, 1, slices, echoes) headers of a sagittal multi-echo series: rows
    along S-I, columns along A-P, slices along L-R, EchoNumbers 1.. and
    EchoTime per echo; one series UID."""
    from dosma_tpu_torch.core.io.dicom import Dataset
    from dosma_tpu_torch.core.io.dicom.writer import generate_uid

    rows, cols, nslices = shape
    series = generate_uid()
    headers = np.empty((1, 1, nslices, len(echo_times)), dtype=object)
    for e, te in enumerate(echo_times):
        for s in range(nslices):
            ds = Dataset()
            ds.SOPInstanceUID = generate_uid()
            ds.SeriesInstanceUID = series
            ds.Modality = "MR"
            ds.InstanceNumber = e * nslices + s + 1
            ds.EchoNumbers = e + 1
            ds.EchoTime = te
            ds.Rows, ds.Columns = rows, cols
            ds.BitsAllocated, ds.BitsStored, ds.HighBit = 16, 16, 15
            ds.PixelRepresentation = 0
            ds.SamplesPerPixel = 1
            ds.PhotometricInterpretation = "MONOCHROME2"
            ds.PixelSpacing = [spacing[0], spacing[1]]
            ds.SliceThickness = spacing[2]
            ds.ImagePositionPatient = [spacing[2] * s, 0.0, 0.0]
            ds.ImageOrientationPatient = [0.0, 1.0, 0.0, 0.0, 0.0, -1.0]
            headers[0, 0, s, e] = ds
    return headers


def write_qdess_series(dir_path: str, shape, seed: int = 7) -> np.ndarray:
    """A two-echo sagittal qDESS series of uint16 noise, written by
    ``DicomWriter`` (the JAX test utility's ``write_dicom_series(plane=
    "sagittal")`` with GE's spoiler tags); returns the pixels (rows, cols,
    slices, echoes)."""
    from dosma_tpu_torch.core.io.dicom import Tag
    from dosma_tpu_torch.core.io.dicom_io import DicomWriter, to_RAS_affine
    from dosma_tpu_torch.core.med_volume import MedicalVolume

    arr = (np.random.RandomState(seed).rand(*shape, 2) * 1000).astype(np.uint16)
    headers = series_headers(shape, (0.5, 0.5, 1.0), (10.0, 20.0))
    for ds in headers.flat:
        ds.RepetitionTime = 20.0
        ds.FlipAngle = 30.0
        ds[Tag(0x0019, 0x10B6)] = 3132.0
        ds[Tag(0x0019, 0x10B7)] = 1560.0
    affine = to_RAS_affine(list(headers[0, 0, :, 0]))
    DicomWriter().save(MedicalVolume(arr, affine, headers=headers), dir_path)
    return arr


def condyle_annulus(shape) -> np.ndarray:
    """The dry run's femoral-cartilage mask: an inferior arc in every slice."""
    h, w, d = shape
    yv, xv = np.mgrid[0:h, 0:w]
    rad = np.sqrt((yv - h * 0.45) ** 2 + (xv - w * 0.5) ** 2)
    annulus = (rad > 6.5) & (rad < 9.5) & (yv > h * 0.45)
    return np.repeat(annulus[..., None], d, axis=2).astype(np.uint8)


def _mono(x_col, params):
    return params[0] * torch.exp(params[1] * x_col)


def flows(workdir: str) -> dict:
    """The five flows on this rank; the summary of each."""
    import dosma_tpu_torch as dt
    from dosma_tpu_torch.models.unet2d import init_unet2d_params
    from dosma_tpu_torch.parallel.sharding import (
        NamedSharding,
        PartitionSpec,
        get_mesh,
        sharded_lm_fit,
        sharded_register_chain_batch,
        sharded_unet_inference,
    )
    from dosma_tpu_torch.train.seg_trainer import SegTrainer

    n = dist.get_world_size() if dist.is_initialized() else 1
    rs = np.random.RandomState(0)
    out = {}

    # A sharded train step: the 256-wide bottleneck is model-sharded.
    trainer = SegTrainer(num_classes=1, features=(16, 32, 256))
    batch = max(n, 4)
    images = rs.rand(batch, 32, 32, 1).astype(np.float32)
    labels = (rs.rand(batch, 32, 32, 1) > 0.7).astype(np.float32)
    loss = trainer.step(images, labels)
    assert np.isfinite(loss), f"non-finite loss: {loss}"
    out["mesh"] = dict(zip(trainer.mesh.axis_names, trainer.mesh.shape))
    out["loss"] = loss

    # A sharded fit over a voxel count the ranks do not divide.
    mesh = get_mesh()
    x = np.array([10.0, 20.0, 30.0, 40.0], np.float32)
    b = -1 / (rs.rand(509).astype(np.float32) * 70 + 10)
    Y = np.exp(b[:, None] * x[None, :]).astype(np.float32)
    popt, _r2, conv = sharded_lm_fit(_mono, x, Y, np.array([1.0, -1 / 30], np.float32),
                                     mesh=mesh, max_iter=60)
    assert popt.shape[0] == 509, "uneven-shard unpad failed"
    assert conv.mean() > 0.95, "sharded fit did not converge"
    out["conv"] = float(conv.mean())

    # Sharded inference over a slice count the ranks do not divide.
    params = init_unet2d_params(torch.Generator().manual_seed(1), num_classes=2,
                                features=(8, 16, 32))
    seg_model = type("ParamsOnly", (), {"params": params})()
    seg = sharded_unet_inference(seg_model, rs.rand(n + 3, 32, 32, 1).astype(np.float32),
                                 mesh=mesh)
    assert seg.shape[0] == n + 3 and np.isfinite(seg).all()
    out["seg_slices"] = seg.shape[0]

    # The sharded qDESS flow: DICOM -> echoes sharded over slices -> T2 -> rows.
    n_sl = n + 3
    series = os.path.join(workdir, "qdess")
    if not dist.is_initialized() or dist.get_rank() == 0:
        write_qdess_series(series, (32, 32, n_sl))
    if dist.is_initialized():
        dist.barrier()
    sharding = NamedSharding(mesh, PartitionSpec(None, None, "data"))
    echoes = dt.load_to_device(series, sharding=sharding)
    t2 = dt.QDess(echoes).generate_t2_map(**QDESS_T2)
    t2_arr = t2.volumetric_map.volume
    ranks = len(t2_arr.device_mesh.mesh.flatten()) if hasattr(t2_arr, "device_mesh") else 1
    full = t2_arr.full_tensor() if hasattr(t2_arr, "full_tensor") else t2_arr
    host = dt.QDess.from_dicom(series).generate_t2_map(**QDESS_T2)
    np.testing.assert_allclose(full.cpu().numpy(), np.asarray(host.volumetric_map.volume),
                               rtol=0, atol=0.11)
    fc = dt.FemoralCartilage(medial_to_lateral=True)
    fc.set_mask(dt.MedicalVolume(condyle_annulus((32, 32, n_sl)), echoes[0].affine),
                use_largest_cc=False, split_regions=True)
    _header, rows, _maps = fc.quant_rows(t2.volumetric_map, t2.qv_type)
    assert len(rows) == 18, f"expected 18 metric rows, got {len(rows)}"
    out.update(n_sl=n_sl, t2_ranks=ranks, rows=len(rows))

    # A sharded batch registration: the moving axis over the ranks.
    fixed = np.zeros((16, 16, 8), np.float32)
    fixed[4:-4, 4:-4, 2:-2] = 1.0
    fixed += 0.05 * rs.rand(16, 16, 8).astype(np.float32)
    movings = np.stack([np.roll(fixed, (s, -s, 0), axis=(0, 1, 2)) for s in (1, 2)])
    Ms, _warped = sharded_register_chain_batch(
        fixed, np.eye(4), movings, np.eye(4),
        [dt.RegistrationParams(transform="translation", metric="mse", resolutions=2,
                               iterations=80, num_samples=1024, learning_rate=0.05)],
        mesh=mesh,
    )
    out["reg_err"] = float(max(abs(Ms[i, 0][:3, 3] - [s, -s, 0]).max()
                               for i, s in enumerate((1, 2))))
    assert out["reg_err"] < 1.0, f"sharded registration off by {out['reg_err']:.2f} vox"
    return out


def summary_line(r: dict) -> str:
    return (
        f"dryrun_multichip OK: mesh={r['mesh']}, train loss={r['loss']:.4f}, "
        f"sharded-fit conv={r['conv']:.3f} (509 voxels uneven), "
        f"sharded-seg slices={r['seg_slices']} (uneven), sharded-qdess-pipeline: "
        f"DICOM({r['n_sl']} uneven slices)->T2 over {r['t2_ranks']} ranks (host-parity OK)->"
        f"{r['rows']} metric rows, sharded-reg err={r['reg_err']:.2f}vox"
    )


def dryrun_multichip(ranks: int, backend: str = "gloo", timeout: float = 600.0) -> str:
    """Run the five flows on a new world of ``ranks``; returns rank 0's line."""
    workdir = tempfile.mkdtemp(prefix="dosma_dryrun_")
    try:
        results = launch(flows, ranks, backend, args=(workdir,), timeout=timeout)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return summary_line(results[0])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=2)
    parser.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    parser.add_argument("--timeout", type=float, default=600.0)
    opts = parser.parse_args(argv)
    print(dryrun_multichip(opts.ranks, opts.backend, opts.timeout), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
