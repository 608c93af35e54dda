"""The port's U-Net trainer and checkpoints (``dosma_tpu_torch/train/``)
against ``dosma_tpu``'s ``SegTrainer`` on its 8-device CPU mesh, and across
gloo worlds of CPU processes.

- ``dice_bce_loss`` and its gradient: 1e-6 against JAX's;
- the trainer at world 1 against JAX's on a 2 x 2 mesh, from the same
  parameters (features (8, 16, 256), so the 256-wide level is
  model-sharded; 32 x 32 images, batch 4): the losses of 3 steps at rtol
  1e-5, the first step's raw gradients against ``jax.grad`` of the same
  loss per leaf within 1e-5 of the leaf's norm (BatchNorm ``mean`` and
  ``var`` included: ``dosma_tpu`` trains them), and a step from an optax
  state carried by ``adam_state_from_optax``. Parameters after an Adam step
  are never compared (Adam's first step is about lr * sign(g));
- the trainer on 2 x 2 (4 ranks), 2 x 1 and 1 x 2 (2 ranks) meshes against
  world 1: raw gradients per leaf at 1e-5 relative, losses at rtol 1e-6
  (only the order of the data ranks' partial sums differs);
- checkpoints: a round trip and ``latest_step``; a resume equal to the live
  trainer bit for bit; a 2-rank (model-sharded) save restored at world 1.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dosma_tpu_torch as dt
from dosma_tpu.models.unet2d import init_unet2d_params as jinit
from dosma_tpu.models.unet2d import unet2d_forward
from dosma_tpu.train import seg_trainer as jtrain
from dosma_tpu_torch.models.unet2d import UNet2D
from dosma_tpu_torch.models.weights import state_dict_from_params
from dosma_tpu_torch.parallel.dryrun import launch
from dosma_tpu_torch.parallel.sharding import make_mesh
from dosma_tpu_torch.train import (
    SegTrainer,
    adam_state_from_optax,
    dice_bce_loss,
    latest_step,
    param_shardings,
    restore_checkpoint,
    save_checkpoint,
)
from dosma_tpu_torch.train.seg_trainer import unet_train_forward
from tests import torch_worlds as W
from tests.test_torch_unet2d import random_unet_params


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU, on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with dt.default_device("cpu"):
            yield
    finally:
        torch.set_num_threads(threads)


FEATURES = (8, 16, 256)


def _params(seed):
    """Narrow U-Net parameters drawn with numpy (JAX's eager He-normal
    draws take many seconds on the CPU)."""
    return random_unet_params(seed=seed, num_classes=1, features=FEATURES)


def _batch(seed=0, n=4):
    rs = np.random.RandomState(seed)
    images = rs.rand(n, 32, 32, 1).astype(np.float32)
    return images, (images > 0.5).astype(np.float32)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_leaves_close(got, want, rtol, what):
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want)
    for k in want:
        err = np.linalg.norm(got[k].astype(np.float64) - want[k])
        assert err <= rtol * max(np.linalg.norm(want[k].astype(np.float64)), 1e-30), \
            f"{what} {k}: |Δ| {err} vs |g| {np.linalg.norm(want[k])}"


# ----------------------------------------------------------------------
# The loss
# ----------------------------------------------------------------------
def test_dice_bce_loss_and_gradient_match_jax():
    rs = np.random.RandomState(3)
    probs = rs.rand(2, 8, 8, 1).astype(np.float32)
    probs[0, 0, 0, 0], probs[0, 0, 1, 0] = 0.0, 1.0  # clipped at eps / 1 - eps
    labels = (rs.rand(2, 8, 8, 1) > 0.5).astype(np.float32)
    want, gwant = jax.value_and_grad(jtrain.dice_bce_loss)(jnp.asarray(probs),
                                                          jnp.asarray(labels))
    p = torch.from_numpy(probs).requires_grad_(True)
    got = dice_bce_loss(p, torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(gwant), rtol=1e-6, atol=1e-9)


def test_dice_bce_loss_perfect_and_bad_predictions():
    labels = torch.from_numpy((np.random.RandomState(0).rand(2, 8, 8, 1) > 0.5)
                              .astype(np.float32))
    assert dice_bce_loss(labels * 0.999 + 5e-4, labels).item() < 0.05
    assert dice_bce_loss(1 - (labels * 0.999 + 5e-4), labels).item() > 1.0


def test_train_forward_equals_the_inference_network():
    params = _params(1)
    x = torch.from_numpy(np.random.RandomState(1).rand(2, 1, 32, 32).astype(np.float32))
    want = UNet2D.from_params(params)(x)
    got = unet_train_forward(dict(state_dict_from_params(params)), x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ----------------------------------------------------------------------
# The trainer against dosma_tpu's
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_run():
    """JAX's trainer on a 2 x 2 mesh: its initial parameters, the raw
    gradients of the first batch, and the losses and states of 5 steps."""
    from jax.sharding import Mesh

    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    trainer = jtrain.SegTrainer(mesh=mesh, features=FEATURES)
    params0 = _host(trainer.params)
    images, labels = _batch()

    def loss_fn(p):
        return jtrain.dice_bce_loss(unet2d_forward(p, jnp.asarray(images)), jnp.asarray(labels))

    grads0 = _host(jax.grad(loss_fn)(params0))
    losses, states = [], []
    for _ in range(5):
        states.append((_host(trainer.params), _host(trainer.opt_state[0])))
        losses.append(trainer.step(images, labels))
    return {"params0": params0, "grads0": grads0, "losses": losses, "states": states}


def test_losses_of_three_steps_match_jax(jax_run):
    trainer = SegTrainer(params=jax_run["params0"])
    assert trainer.mesh.shape == (1, 1) and trainer.mesh.device_mesh is None
    images, labels = _batch()
    losses = [trainer.step(images, labels) for _ in range(3)]
    np.testing.assert_allclose(losses, jax_run["losses"][:3], rtol=1e-5)
    assert losses[-1] < losses[0]


def test_first_step_gradients_match_jax_grad(jax_run):
    trainer = SegTrainer(params=jax_run["params0"])
    loss, grads = trainer.loss_and_grads(*_batch())
    np.testing.assert_allclose(loss, jax_run["losses"][0], rtol=1e-6)
    _assert_leaves_close(grads, jax_run["grads0"], 1e-5, "gradient")
    for blk in grads["down"] + grads["up"]:  # the statistics are trained
        assert np.abs(blk["bn"]["mean"]).max() > 0 and np.abs(blk["bn"]["var"]).max() > 0


def test_step_from_a_carried_optax_state(jax_run):
    params, opt = jax_run["states"][3]  # after 3 steps
    trainer = SegTrainer(params=params)
    trainer.load_opt_state(adam_state_from_optax(opt.count, opt.mu, opt.nu))
    assert float(trainer.optimizer.state[trainer.params["final.bias"]]["step"]) == 3
    images, labels = _batch()
    losses = [trainer.step(images, labels) for _ in range(2)]
    np.testing.assert_allclose(losses, jax_run["losses"][3:5], rtol=1e-5)


def _jax_leaf_paths_sharded(params):
    shardings = jtrain.param_shardings(params, jax.sharding.Mesh(
        np.asarray(jax.devices()).reshape(4, 2), ("data", "model")))
    return {jax.tree_util.keystr(k) for k, s in jax.tree_util.tree_leaves_with_path(
        shardings, is_leaf=lambda s: hasattr(s, "spec")) if "model" in tuple(s.spec)}


def _port_name_to_path(name):
    parts = name.split(".")
    leaf = {"weight": "w", "bias": "b"}.get(parts[-1], parts[-1])
    if parts[0] == "final":
        return f"['final']['{leaf}']"
    return f"['{parts[0]}'][{parts[1]}]['{parts[2]}']['{leaf}']"


def test_param_shardings_shard_the_leaves_jax_shards():
    sd = UNet2D().state_dict()  # full width
    shardings = param_shardings(sd, make_mesh((1, 1), ("data", "model")))
    assert tuple(shardings["down.5.conv1.weight"].spec) == ("model", None, None, None)
    assert all(a is None for a in shardings["down.0.conv1.weight"].spec)
    assert tuple(shardings["up.4.convT.weight"].spec) == (None, "model", None, None)
    port = {_port_name_to_path(k) for k, s in shardings.items() if "model" in tuple(s.spec)}
    jparams = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0)))
    assert port == _jax_leaf_paths_sharded(jparams)


# ----------------------------------------------------------------------
# Across worlds, and checkpoints
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """World 1 and the 2 x 2, 2 x 1 and 1 x 2 meshes from one set of
    parameters; the 1 x 2 trainer saves a checkpoint at step 2."""
    params = _params(2)
    images, labels = _batch(seed=5)
    ckpt = str(tmp_path_factory.mktemp("ckpt_two_ranks"))
    with dt.default_device("cpu"):
        world1 = W.trainer_grads([(1, 1)], params, images, labels)
    four = launch(W.trainer_grads, 4, "gloo", ([(2, 2)], params, images, labels))
    two = launch(W.trainer_grads, 2, "gloo", ([(2, 1), (1, 2)], params, images, labels, ckpt))
    return {"params": params, "world1": world1[(1, 1)], "four": four, "two": two,
            "ckpt": ckpt}


@pytest.mark.parametrize("shape", [(2, 2), (2, 1), (1, 2)])
def test_gradients_and_losses_agree_across_worlds(worlds, shape):
    loss1, grads1, losses1 = worlds["world1"]
    ranks = worlds["four"] if shape == (2, 2) else worlds["two"]
    for rank in ranks:
        loss, grads, losses = rank[shape]
        np.testing.assert_allclose(loss, loss1, rtol=1e-6)
        _assert_leaves_close(grads, grads1, 1e-5, f"{shape} gradient")
        np.testing.assert_allclose(losses, losses1, rtol=1e-6)


def test_two_rank_checkpoint_restores_at_world_one(worlds):
    saved_params, saved_mu, saved_count = worlds["two"][0]["saved"]
    assert latest_step(worlds["ckpt"]) == 2
    trainer = SegTrainer(params=worlds["params"])
    trainer.restore(worlds["ckpt"])
    _assert_leaves_close(trainer.host_params(), saved_params, 0.0, "restored parameter")
    state = trainer.state()["opt_state"]
    for k, v in saved_mu.items():
        np.testing.assert_array_equal(state["mu"][k].numpy(), v)
    assert float(state["count"]) == saved_count == 2.0
    whole = restore_checkpoint(worlds["ckpt"], 2)  # no target: whole CPU tensors
    np.testing.assert_array_equal(whole["params"]["down.2.conv1.weight"].numpy(),
                                  trainer.params["down.2.conv1.weight"].detach().numpy())


def test_save_restore_round_trip_and_latest_step(tmp_path):
    params = _params(0)
    save_checkpoint(str(tmp_path), 10, params)
    save_checkpoint(str(tmp_path), 20, params)
    assert latest_step(str(tmp_path)) == 20
    assert latest_step(str(tmp_path / "missing")) is None
    out = restore_checkpoint(str(tmp_path))
    assert isinstance(out["params"]["down"], list) and len(out["params"]["up"]) == 2
    np.testing.assert_array_equal(out["params"]["down"][0]["conv1"]["w"].numpy(),
                                  params["down"][0]["conv1"]["w"])
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "missing"))


def test_resume_equals_the_live_trainer(tmp_path):
    params = _params(3)
    images, labels = _batch(seed=7)
    live = SegTrainer(params=params)
    for _ in range(3):
        live.step(images, labels)
    live.save(str(tmp_path), 3)
    fresh = SegTrainer(params=params)
    fresh.restore(str(tmp_path))
    assert live.step(images, labels) == fresh.step(images, labels)
    for k, p in live.params.items():
        torch.testing.assert_close(fresh.params[k], p, rtol=0, atol=0)
        for s in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(fresh.optimizer.state[fresh.params[k]][s],
                                       live.optimizer.state[p][s], rtol=0, atol=0)


def test_make_sharded_train_step_takes_the_trainers_steps():
    from dosma_tpu_torch.train import make_sharded_train_step

    images, labels = _batch(seed=9, n=2)
    params, optimizer, train_step, place_batch = make_sharded_train_step(
        make_mesh((1, 1), ("data", "model")), params=_params(9))
    assert all(p.requires_grad for p in params.values())
    x, y = place_batch(images, labels)
    assert tuple(x.shape) == (2, 1, 32, 32) and x.dtype == torch.float32
    before = {k: p.detach().clone() for k, p in params.items()}
    losses = [float(train_step(x, y)) for _ in range(2)]
    assert all(optimizer.state[p]["step"] == 2 for p in params.values())
    assert any(not torch.equal(p.detach(), before[k]) for k, p in params.items())
    trainer = SegTrainer(params=_params(9))
    assert losses == [trainer.step(images, labels) for _ in range(2)]
