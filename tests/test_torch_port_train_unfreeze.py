"""A mid-run unfreeze of RAFT (``train.freeze_flow_steps: 1``, lane-wise
lookup) over two steps against the JAX PoseNetTrainer on the CPU: step 1
keeps RAFT still while its gradients are live; step 2 moves it with Adam
moments that ramp from zero under the one step count shared by every
parameter."""
import jax
import numpy as np
import pytest
import torch

from robust_pose_tpu_torch.utils.convert import params_from_jax, train_state_from_jax
from tests.test_torch_port_common import (  # noqa: F401 (fixture)
    two_torch_threads,
    jax_trainer,
    port_trainer,
    train_batch,
    train_config,
    train_weights,
)

# a small learning rate: Adam's first step moves every parameter by ~lr
# whatever its gradient, and the sign of that step is rounding noise where
# the gradient is (a bias that a batch norm cancels); a small step keeps
# that noise out of the second step's gradients
LR = 1e-6
CFG = train_config(freeze_flow_steps=1, learning_rate=LR)
CFG["model"]["lookup"] = "lanewise"


pytestmark = pytest.mark.usefixtures("two_torch_threads")


@pytest.fixture(scope="module")
def two_steps():
    sd = train_weights(seed=31)
    batches = [train_batch(seed=7), train_batch(seed=8)]
    jtr, jst, _ = jax_trainer(CFG, sd)
    ptr, pst = port_trainer(CFG, sd)
    out = {"sd": sd, "batches": batches, "jax": [], "port": []}
    step = jtr.make_train_step()
    for batch in batches:
        with jax.default_matmul_precision("float32"):
            jst, jm = step(jst, batch)
        out["jax"].append((train_state_from_jax(jst), jm))
        pst, pm = ptr.train_step(pst, batch)
        out["port"].append((
            {k: v.detach().clone() for k, v in pst.params.items()},
            {k: v.clone() for k, v in pst.opt_state.mu.items()},
            {k: v.clone() for k, v in pst.opt_state.nu.items()},
            pst.opt_state.count, pm))
    return out


def test_raft_still_on_step_one_and_moving_on_step_two(two_steps):
    """Bit-identical RAFT after the frozen step in both packages, moved in
    both after the unfreeze; the heads move on both steps."""
    sd = two_steps["sd"]
    for i, moved in ((0, False), (1, True)):
        jnew = two_steps["jax"][i][0]["state_dict"]
        pnew = two_steps["port"][i][0]
        k = "flow.fnet.conv1.weight"
        assert torch.equal(jnew[k], sd[k]) is not moved
        assert torch.equal(pnew[k], sd[k]) is not moved
        k = "weight_head_2d.unet.head.weight"
        assert not torch.equal(pnew[k], sd[k])


def test_two_step_schedule_matches_jax(two_steps):
    """After both steps: the shared count, the loss of each step (rtol
    1e-4), every Adam moment per leaf in relative L2 error (mu 5e-3, nu
    1e-2: a pixel whose depth validity or flow bound sits on the threshold
    can fall on either side in the two packages and move a few elements of
    a high-resolution encoder kernel by ~1%) and every parameter within
    2 lr (each step moves a parameter by at most ~lr, in a direction that
    is rounding noise where the gradient is)."""
    (jstate, _), (pparams, pmu, pnu, pcount, _) = (two_steps["jax"][1],
                                                   two_steps["port"][1])
    assert jstate["count"] == pcount == 2
    for i in range(2):
        np.testing.assert_allclose(
            float(two_steps["port"][i][4]["train/loss_total"]),
            float(two_steps["jax"][i][1]["train/loss_total"]), rtol=1e-4)
    for name, j, p, rtol in (("mu", jstate["mu"], pmu, 5e-3),
                             ("nu", jstate["nu"], pnu, 1e-2)):
        floor = 2e-5 * max(float(v.norm()) for v in j.values())
        for k, v in j.items():
            err = float((p[k] - v).norm())
            assert err <= rtol * float(v.norm()) + floor, (name, k, err)
    for k, v in jstate["state_dict"].items():
        got = pparams[k] if k in pparams else None
        if got is not None:
            np.testing.assert_allclose(got.numpy(), v.numpy(), rtol=0,
                                       atol=2 * LR, err_msg=k)


def test_resume_from_jax_state_matches_jax(two_steps):
    """The port's trainer started from the JAX state after the frozen step
    (``train_state_from_jax``: weights, batch statistics, Adam moments,
    count 1, step 1) takes the unfreezing step as the JAX trainer did:
    count 2, RAFT moved, every parameter within 2 lr of the JAX result
    and the Adam second moments within 1e-2 of each leaf's norm in L2."""
    from robust_pose_tpu_torch.train.trainer import PoseNetTrainer

    j1, j2 = two_steps["jax"][0][0], two_steps["jax"][1][0]
    assert j1["count"] == 1 and j1["step"] == 1
    tr = PoseNetTrainer(CFG, device="cpu")
    st = tr.init_state(j1)
    st, _ = tr.train_step(st, two_steps["batches"][1])
    assert st.opt_state.count == 2 and st.step == 2
    k = "flow.fnet.conv1.weight"
    assert not torch.equal(st.params[k].detach(), j1["state_dict"][k])
    for k, v in j2["state_dict"].items():
        got = st.params[k].detach() if k in st.params else st.batch_stats[k]
        np.testing.assert_allclose(got.numpy(), v.numpy(), rtol=1e-4,
                                   atol=2 * LR, err_msg=k)
    floor = 2e-5 * max(float(v.norm()) for v in j2["nu"].values())
    for k, v in j2["nu"].items():
        err = float((st.opt_state.nu[k] - v).norm())
        assert err <= 1e-2 * float(v.norm()) + floor, (k, err)
