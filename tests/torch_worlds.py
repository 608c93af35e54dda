"""Rank functions of the port's multi-rank tests.

``dosma_tpu_torch.parallel.dryrun.launch`` runs one of these on every rank
of a gloo world (each rank a new process on the CPU, one thread). They
import torch and the port only, so a rank starts quickly; the inputs and
the JAX package's draws come from the test, as numpy arrays.
"""

import numpy as np
import torch


def mono_user(x_col, params):
    return params[0] * torch.exp(params[1] * x_col)


def offset_exp_user(x_col, params):
    return params[0] * torch.exp(params[1] * x_col) + params[2]


def _model(kind):
    from dosma_tpu_torch.core import fitting

    return {"mono_user": mono_user, "offset_exp_user": offset_exp_user,
            "monoexponential": fitting.monoexponential,
            "biexponential": fitting.biexponential}[kind]


def run_fits(cases):
    """``sharded_lm_fit`` of each case ``name -> (model, x, Y, p0, kernel,
    kwargs)`` on the default 1-D mesh; ``name -> (popt, r2, converged)``."""
    from dosma_tpu_torch.parallel.sharding import sharded_lm_fit

    return {name: sharded_lm_fit(_model(kind), x, Y, p0, kernel=kernel, **kw)
            for name, (kind, x, Y, p0, kernel, kw) in cases.items()}


def fits_and_inference(cases, seg_params, slices):
    """The sharded fits, then ``sharded_unet_inference`` of ``slices``."""
    from dosma_tpu_torch.parallel.sharding import sharded_unet_inference

    model = type("ParamsOnly", (), {"params": seg_params})()
    return run_fits(cases), sharded_unet_inference(model, slices)


def _placements(dtensor):
    """A DTensor's placements as ``(kind, dim)`` pairs."""
    return [(type(p).__name__, getattr(p, "dim", None)) for p in dtensor.placements]


def install_draws(table):
    """Replace the registration's per-level draws by ``table[(seed, level,
    iterations, num_samples)]`` (the JAX package's own draws)."""
    from dosma_tpu_torch.ops import registration as treg

    def draws(seed, level, iterations, num_samples, device):
        return torch.from_numpy(table[(int(seed), int(level), int(iterations),
                                       int(num_samples))]).to(device)

    treg._level_draws = draws


def registration_and_qdess(draws, fixed, movings, cfgs, series_dir, mask, t2_kwargs,
                           dryrun_dir):
    """The dry run's five flows (``parallel.dryrun.flows``), then a sharded
    registration with injected draws and the sharded qDESS flow:
    ``load_to_device(sharding=...)`` -> ``generate_t2_map`` -> femoral
    cartilage's rows. Returns the registration's ``(Ms, warped)``, the T2
    map's placements, its local shape and whole array, the rows, the dry
    run's summary and :func:`device_choices`."""
    import dosma_tpu_torch as dt
    from dosma_tpu_torch.parallel.dryrun import flows
    from dosma_tpu_torch.parallel.sharding import (
        NamedSharding,
        PartitionSpec,
        get_mesh,
        sharded_register_chain_batch,
    )

    dryrun = flows(dryrun_dir)
    install_draws(draws)
    reg = sharded_register_chain_batch(
        fixed, np.eye(4), movings, np.eye(4), [dt.RegistrationParams(**c) for c in cfgs])

    mesh = get_mesh()
    echoes = dt.load_to_device(series_dir, sharding=NamedSharding(
        mesh, PartitionSpec(None, None, "data")))
    t2 = dt.QDess(echoes).generate_t2_map(**t2_kwargs)
    vol = t2.volumetric_map.volume
    placements = _placements(vol)
    local_shape = tuple(vol.to_local().shape)
    whole = vol.full_tensor().numpy()
    fc = dt.FemoralCartilage(medial_to_lateral=True)
    fc.set_mask(dt.MedicalVolume(mask, echoes[0].affine), use_largest_cc=False,
                split_regions=True)
    rows = fc.quant_rows(t2.volumetric_map, t2.qv_type)
    return reg, placements, local_shape, whole, rows[:2], dryrun, device_choices()


def _mono_case():
    x = np.array([10.0, 20.0, 30.0, 40.0], np.float32)
    b = -1 / (np.random.RandomState(0).rand(101).astype(np.float32) * 70 + 10)
    return x, np.exp(b[:, None] * x[None, :]).astype(np.float32), np.array([1.0, -1 / 30],
                                                                           np.float32)


def device_choices():
    """Where a rank of this world computes (``Mesh.device_for``) host data
    and a CPU tensor, and what the sharded fit of host data does once the
    default device is the first card again: ``"computed"`` or the error."""
    from dosma_tpu_torch.core import fitting
    from dosma_tpu_torch.core.device import get_default_device, set_default_device
    from dosma_tpu_torch.parallel.sharding import get_mesh, sharded_lm_fit

    mesh = get_mesh()
    out = {"host": str(mesh.device_for(np.zeros(2))),
           "cpu_tensor": str(mesh.device_for(torch.zeros(2)))}
    previous = get_default_device()
    set_default_device(None)
    try:
        sharded_lm_fit(fitting.monoexponential, *_mono_case())
        out["card_default"] = "computed"
    except RuntimeError as e:
        out["card_default"] = str(e)
    finally:
        set_default_device(previous)
    return out


def card_default_fits():
    """With the default device the first card again: the sharded fit of a
    card ``Y`` and of the host ``Y``, each as ``(monoexp_lm launches, the
    rows' device, popt)``."""
    from dosma_tpu_torch.core import fitting
    from dosma_tpu_torch.core.device import set_default_device
    from dosma_tpu_torch.parallel.sharding import sharded_lm_fit
    from dosma_tpu_torch.utils.profiling import counters

    set_default_device(None)
    x, Y, p0 = _mono_case()
    out = {}
    for name, y in (("card", torch.from_numpy(Y).cuda()), ("host", Y)):
        before = counters["monoexp_lm.launches"]
        popt = sharded_lm_fit(fitting.monoexponential, x, y, p0)[0]
        where = str(popt.device) if isinstance(popt, torch.Tensor) else "numpy"
        out[name] = (counters["monoexp_lm.launches"] - before, where, np.asarray(torch.as_tensor(popt).cpu()))
    return out


def place_series(series_dir):
    """``load_to_device(sharding=...)`` of a series over the slice axis:
    each volume's placements, local block and whole array."""
    import dosma_tpu_torch as dt
    from dosma_tpu_torch.parallel.sharding import NamedSharding, PartitionSpec, get_mesh

    vols = dt.load_to_device(series_dir, sharding=NamedSharding(
        get_mesh(), PartitionSpec(None, None, "data")))
    return [(_placements(v.A), v.A.to_local().numpy(), v.A.full_tensor().numpy(),
             v.affine, v.get_metadata("EchoTime")) for v in vols]


def trainer_grads(shapes, params, images, labels, ckpt_dir=None):
    """For each mesh shape ``(data, model)``: the loss and raw gradients of
    one batch, then the losses of two steps. With ``ckpt_dir``, the last
    trainer saves a checkpoint at step 2 and returns its whole state."""
    from dosma_tpu_torch.parallel.sharding import make_mesh
    from dosma_tpu_torch.train.seg_trainer import SegTrainer

    out = {}
    for shape in shapes:
        trainer = SegTrainer(mesh=make_mesh(shape, ("data", "model")), params=params)
        loss, grads = trainer.loss_and_grads(images, labels)
        losses = [trainer.step(images, labels) for _ in range(2)]
        out[tuple(shape)] = (loss, grads, losses)
    if ckpt_dir is not None:
        trainer.save(ckpt_dir, 2)
        state = trainer.state()
        out["saved"] = (trainer.host_params(),
                        {k: v.full_tensor().numpy() for k, v in state["opt_state"]["mu"].items()},
                        float(state["opt_state"]["count"]))
    return out
