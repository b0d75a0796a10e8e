"""One training step with live RAFT gradients through the lane-wise lookup
(``train.freeze_flow_steps: 0``, ``model.lookup: lanewise``) against the
JAX PoseNetTrainer on the CPU, where the JAX package runs the lane-wise
Pallas kernels in interpret mode: the same weights and batch, f32."""
import jax
import numpy as np
import pytest
import torch

from tests.test_torch_port_common import (  # noqa: F401 (fixture)
    two_torch_threads,
    assert_step_matches,
    jax_grads_from_first_step,
    jax_trainer,
    port_trainer,
    train_batch,
    train_config,
    train_weights,
)

CFG = train_config(freeze_flow_steps=0)
CFG["model"]["lookup"] = "lanewise"


pytestmark = pytest.mark.usefixtures("two_torch_threads")


@pytest.fixture(scope="module")
def step_b():
    sd = train_weights()
    batch = train_batch(seed=1)
    jtr, jst, _ = jax_trainer(CFG, sd)
    assert jtr.model.config["stop_flow_grad"] is False
    with jax.default_matmul_precision("float32"):
        jst1, jm = jtr.make_train_step()(jst, batch)
    ptr, pst = port_trainer(CFG, sd)
    cfg = ptr.model.config
    assert not cfg["stop_flow_grad"] and cfg["lookup"] == "lanewise"
    pst, pm = ptr.train_step(pst, batch)
    return {"sd": sd, "jm": jm, "pm": pm, "jst1": jst1, "pst": pst,
            "jgrads": jax_grads_from_first_step(jst1, jm, 1.0),
            "pgrads": ptr.seen_grads[0]}


def test_live_step_matches_jax(step_b):
    """Loss, every gradient, RAFT's included (rtol 5e-3 of the leaf's
    scale: the gradient now runs back through 2 GRU iterations, the
    lookups, the correlation volume and both encoders), the updated
    parameters and BatchNorm statistics."""
    assert_step_matches(step_b, grad_rtol=5e-3)


def test_live_step_moves_raft(step_b):
    """RAFT gets non-zero gradients in both packages (through the encoders,
    the GRU and the volume) and every RAFT parameter with a gradient
    moves."""
    jg, pg, pst, sd = step_b["jgrads"], step_b["pgrads"], step_b["pst"], step_b["sd"]
    for k in ("flow.fnet.conv1.weight", "flow.cnet.conv1.weight",
              "flow.update.update_block.encoder.convc1.weight",
              "flow.update.update_block.gru.convz1.weight",
              "flow.update.update_block.flow_head.conv2.weight",
              "weight_head_3d.unet.head.weight", "loss_weight"):
        assert np.abs(jg[k].numpy()).max() > 0 and pg[k].abs().max() > 0, k
    for k, p in pst.params.items():
        if k.startswith("flow.") and pg[k].abs().max() > 0:
            assert not torch.equal(p.detach(), sd[k]), k
