"""One training step of the published configuration's path against the JAX
PoseNetTrainer on the CPU: RAFT frozen and cut off by ``stop_flow_grad``
(the default without ``freeze_flow_steps``), weight heads on, f32, the same
weights and batch; and two equivalences inside the port (remat, gradient
accumulation)."""
import copy

import jax
import numpy as np
import pytest
import torch

from robust_pose_tpu_torch.train.trainer import PoseNetTrainer
from robust_pose_tpu_torch.utils.convert import train_state_from_jax
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

CFG = train_config()


pytestmark = pytest.mark.usefixtures("two_torch_threads")


@pytest.fixture(scope="module")
def step_a():
    sd = train_weights()
    batch = train_batch(seed=1)
    jtr, jst, _ = jax_trainer(CFG, sd)
    assert jtr.model.config["stop_flow_grad"] is True
    with jax.default_matmul_precision("float32"):
        jst1, jm = jtr.make_train_step()(jst, batch)
    ptr, pst = port_trainer(CFG, sd)
    assert ptr.model.config["stop_flow_grad"] is True
    assert ptr.model.config["lookup"] == "auto" and not ptr.model.config["remat"]
    pst, pm = ptr.train_step(pst, batch)
    return {"sd": sd, "jm": jm, "pm": pm, "jst1": jst1, "pst": pst,
            "jgrads": jax_grads_from_first_step(jst1, jm, 1.0),
            "pgrads": ptr.seen_grads[0]}


def test_frozen_step_matches_jax(step_a):
    """Loss, every gradient (rtol 2e-3 of the leaf's scale: f32 through 2
    GRU iterations, the LM solve and the IFT backward's Hessian solve),
    the updated parameters and BatchNorm statistics."""
    assert_step_matches(step_a, grad_rtol=2e-3)


def test_frozen_step_moves_heads_not_raft(step_a):
    """The weight heads and the loss weights get non-zero gradients in
    both packages (the IFT optimality check passed) and move; RAFT gets
    none and stays bit-identical; the heads' running statistics move."""
    jg, pg, pst, sd = step_a["jgrads"], step_a["pgrads"], step_a["pst"], step_a["sd"]
    for k in ("weight_head_2d.unet.head.weight", "weight_head_3d.unet.head.weight",
              "loss_weight"):
        assert np.abs(jg[k].numpy()).max() > 0 and pg[k].abs().max() > 0, k
        assert not torch.equal(pst.params[k].detach(), sd[k]), k
    for k, p in pst.params.items():
        if k.startswith("flow."):
            assert pg[k] is None and torch.equal(p.detach(), sd[k]), k
    k = "weight_head_2d.unet.enc0.norm.running_mean"
    assert not torch.equal(pst.batch_stats[k], sd[k])
    j = train_state_from_jax(step_a["jst1"])
    assert j["count"] == pst.opt_state.count == 1 and pst.step == 1


def _port_step(config, sd, batch):
    tr, st = port_trainer(config, sd)
    st, m = tr.train_step(st, batch)
    return tr.seen_grads[0], st, m


def test_remat_equals_no_remat():
    """Recomputing the encoders and GRU iterations in the backward pass
    (RAFT live, so the recomputation has consumers) gives the same loss,
    gradients and update: atol 1e-6 of each leaf's scale (the same f32
    operations, run twice)."""
    sd = train_weights(seed=5)
    batch = train_batch(seed=2)
    out = []
    for remat in (False, True):
        cfg = copy.deepcopy(CFG)
        cfg["train"]["freeze_flow_steps"] = 0
        cfg["model"]["remat"] = remat
        out.append(_port_step(cfg, sd, batch))
    (g0, s0, m0), (g1, s1, m1) = out
    np.testing.assert_allclose(float(m1["train/loss_total"]),
                               float(m0["train/loss_total"]), rtol=1e-6)
    assert float(m0["train/grad_norm"]) > 0
    for k, g in g0.items():
        scale = float(g.abs().max())
        np.testing.assert_allclose(g1[k].numpy(), g.numpy(), rtol=0,
                                   atol=1e-6 * scale + 1e-12, err_msg=k)


def test_grad_accum_equals_single_pass():
    """train.grad_accum = 2 against 1, weights off (no BatchNorm in
    training, so the step is microbatch-invariant, as the JAX package's
    test has it). Batches of 2 and 4 may take other convolution algorithms,
    and the LM solve stops at a step of 1e-6, so the poses agree to about
    that: loss rtol 1e-4, gradients atol 1e-3 of each leaf's scale plus
    2e-5 of the largest (the JAX package's test holds the grad norm at
    rtol 1e-3)."""
    sd = train_weights(seed=6)
    batch = train_batch(seed=3, b=4)
    out = []
    for accum in (1, 2):
        cfg = copy.deepcopy(CFG)
        cfg["model"]["use_weights"] = False
        cfg["train"]["grad_accum"] = accum
        out.append(_port_step(cfg, sd, batch))
    (g1, s1, m1), (g2, s2, m2) = out
    np.testing.assert_allclose(float(m2["train/loss_total"]),
                               float(m1["train/loss_total"]), rtol=1e-4)
    assert g1["loss_weight"].abs().max() > 0
    floor = 2e-5 * max(float(g.abs().max()) for g in g1.values() if g is not None)
    for k, g in g1.items():
        if g is None:
            assert g2[k] is None, k
            continue
        scale = float(g.abs().max())
        np.testing.assert_allclose(g2[k].numpy(), g.numpy(), rtol=0,
                                   atol=1e-3 * scale + floor, err_msg=k)


def test_val_step_runs_on_running_statistics(step_a):
    """val_step: finite metrics, no gradient, BatchNorm statistics
    untouched."""
    tr = PoseNetTrainer(CFG, device="cpu")
    st = tr.init_state(step_a["sd"])
    before = {k: v.clone() for k, v in st.batch_stats.items()}
    m = tr.val_step(st, train_batch(seed=4))
    assert np.isfinite(float(m["val/loss"]))
    for k, v in st.batch_stats.items():
        assert torch.equal(v, before[k]), k
