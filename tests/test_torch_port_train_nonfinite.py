"""A non-finite training gradient that is the JAX package's own: where a
stereo flow's x component is zero, ``PoseNet.disparity_to_depth`` divides
the baseline by zero, the validity mask hides the infinite depth, and the
division's backward gives 0 * inf = NaN, which reaches every RAFT
parameter. The loss and every gradient outside RAFT stay finite.

The same weights and batch go through the JAX PoseNetTrainer's loss
gradient and the port's training step on the CPU (RAFT small at 64x96,
live RAFT, f32): both give NaN at exactly the same leaves.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_common import (  # noqa: F401 (fixture)
    jax_trainer,
    port_trainer,
    random_state_dict,
    train_batch,
    train_config,
    two_torch_threads,
)

pytestmark = pytest.mark.usefixtures("two_torch_threads")

HEAD = "flow.update.update_block.flow_head.conv2."


def _config():
    cfg = train_config(freeze_flow_steps=0)
    cfg["model"]["small"] = True
    return cfg


def _zero_flow_weights():
    """Random small-PoseNet weights with RAFT's flow head zeroed: every
    flow RAFT predicts, the stereo ones included, is exactly 0."""
    from robust_pose_tpu_torch.models.posenet import PoseNet

    cfg = dict(_config()["model"], image_shape=(64, 96))
    sd = random_state_dict(PoseNet(cfg, device="cpu"), 21)
    sd[HEAD + "weight"] = torch.zeros_like(sd[HEAD + "weight"])
    sd[HEAD + "bias"] = torch.zeros_like(sd[HEAD + "bias"])
    return sd


@pytest.fixture(scope="module")
def grads():
    """Raw gradients and losses of the JAX trainer's loss (before the
    clip, which spreads a NaN norm to every leaf) and of the port's step."""
    from robust_pose_tpu_torch.utils.convert import params_from_jax

    cfg, sd = _config(), _zero_flow_weights()
    batch = train_batch(seed=1)
    jtr, jst, _ = jax_trainer(cfg, sd)
    assert jtr.model.config["stop_flow_grad"] is False
    grad_fn = jax.jit(jax.value_and_grad(jtr._loss_fn, has_aux=True))
    with jax.default_matmul_precision("float32"):
        (jloss, (jloss_pose, _)), jg = grad_fn(
            jst.params, jst.batch_stats, tuple(jnp.asarray(x) for x in batch),
            jst.step)
    jgrads = params_from_jax({"params": jax.device_get(jg)})
    ptr, pst = port_trainer(cfg, sd)
    pst, pm = ptr.train_step(pst, batch)
    return {"jgrads": jgrads, "jloss_pose": np.asarray(jloss_pose),
            "pgrads": ptr.seen_grads[0], "pm": pm}


def _non_finite(g):
    return sorted(k for k, v in g.items()
                  if v is not None and not bool(torch.isfinite(torch.as_tensor(v)).all()))


def test_zero_stereo_flow_gives_the_same_non_finite_leaves_as_jax(grads):
    jbad, pbad = _non_finite(grads["jgrads"]), _non_finite(grads["pgrads"])
    assert jbad == pbad
    raft = sorted(k for k in grads["pgrads"] if k.startswith("flow."))
    assert pbad == raft, "every RAFT gradient, and only those"
    assert not np.isfinite(float(grads["pm"]["train/grad_norm"]))


def test_zero_stereo_flow_keeps_the_loss_finite(grads):
    """The per-sample losses agree (f32) and are finite in both: the
    printed loss gives no sign of the NaN."""
    pl = float(grads["pm"]["train/loss_total"])
    jl = float(np.nanmean(grads["jloss_pose"].sum(-1)))
    assert np.isfinite(pl) and np.isfinite(jl)
    assert pl == pytest.approx(jl, rel=1e-5)


@pytest.mark.parametrize("zero", [0.0, -0.0])
def test_depth_division_backward_is_nan_at_a_zero_flow_pixel(zero):
    """disparity_to_depth alone, in both packages: one stereo-flow pixel
    with x = 0 (invalid, masked) gives a NaN flow gradient at that pixel
    and nowhere else, however the masked depth is used downstream."""
    from robust_pose_tpu.models.posenet import PoseNet as JPoseNet
    from robust_pose_tpu_torch.models.posenet import PoseNet as PPoseNet

    rng = np.random.default_rng(0)
    flow = -rng.uniform(1.0, 4.0, (2, 4, 5, 2)).astype(np.float32)
    flow[1, 2, 3, 0] = zero
    bl = np.array([0.5, 0.7], np.float32)

    def jloss(f):
        d, v = JPoseNet.disparity_to_depth(f, jnp.asarray(bl))
        return jnp.sum(jnp.where(v, d, 0.0))

    jg = np.asarray(jax.grad(jloss)(jnp.asarray(flow)))
    f = torch.from_numpy(flow).requires_grad_()
    d, v = PPoseNet.disparity_to_depth(f, torch.from_numpy(bl))
    torch.where(v, d, 0.0).sum().backward()
    pg = f.grad.numpy()
    for g in (jg, pg):
        bad = np.argwhere(~np.isfinite(g))
        np.testing.assert_array_equal(bad, [[1, 2, 3, 0]])
    ok = np.isfinite(pg)
    np.testing.assert_allclose(pg[ok], jg[ok], rtol=1e-6)
