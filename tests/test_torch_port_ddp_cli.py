"""The training CLI and ``bench_train_step`` data-parallel on the CPU: two
gloo processes spawned once for the module run
``scripts.train_posenet.run(..., mesh=...)`` (2 steps, one validation, on
tests/test_torch_port_train_cli.py's PNG sequences at 64x96, RAFT frozen)
at global batch 2 and at global batch 4 with ``grad_accum`` 2, and then
``bench_train_step.main(..., mesh=...)`` at global batch 2; the world-1
CLI runs in this process on the same data.

Each step's batch is recorded on every rank: put together in the JAX
layout, the ranks' rows are world 1's global batch bit for bit. Each
step's metrics (global-batch quantities) and the validation loss are
held to world 1's at rtol 2e-3, Adam's moments after the two steps
within 2e-3 of each leaf's largest plus 1e-6 of the largest of all, the
bounds of tests/test_torch_port_ddp.py: the ranks' batch-1 convolutions
and summed statistics round otherwise than one process on the whole
batch, and the f32 LM's iteration counts follow those last bits. Every
weight within 2 lr x the steps plus 1e-4 of its leaf's largest value (at
the CLI tests' lr 1e-6, Adam moves a weight whose gradient is rounding
noise by ~lr in a direction that rounding picks). RAFT, frozen, bit for
bit.
"""
import contextlib
import copy
import io
import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from robust_pose_tpu_torch.parallel import mesh as M
from tests.test_torch_port_common import (  # noqa: F401 (fixture)
    TRAIN_H,
    TRAIN_W,
    train_weights,
    two_torch_threads,
)
from tests.test_torch_port_train_cli import LR, cli_config, write_sequence

WORLD = 2
STEPS = 2                     # epochs 1: the loop stops once past its count
RTOL = 2e-3
CASES = {"plain": 1, "accum": 2}   # train.grad_accum; global batch 2 x it
JOIN_S = 300

pytestmark = pytest.mark.usefixtures("two_torch_threads")


def _cli(args_list, cfg, data, mesh=None):
    """The port's CLI ``run`` with validation every 2 steps; returns the
    final state, the validation losses and each step's batch (this rank's
    rows) and metrics."""
    from robust_pose_tpu_torch.scripts import train_posenet as cli
    from robust_pose_tpu_torch.train.trainer import PoseNetTrainer

    losses, steps = [], []
    inner, freq, step = cli.run_val, cli.VAL_FREQ, PoseNetTrainer.train_step

    def recorded(*a, **kw):
        losses.append(inner(*a, **kw))
        return losses[-1]

    def train_step(self, state, batch):
        state, m = step(self, state, batch)
        steps.append({"batch": [x.cpu().numpy() for x in batch],
                      "metrics": {k: float(v) for k, v in m.items()}})
        return state, m

    cli.run_val, cli.VAL_FREQ = recorded, 2
    PoseNetTrainer.train_step = train_step
    try:
        args = cli.build_parser().parse_args(args_list)
        state = cli.run(args, copy.deepcopy(cfg), *data, mesh=mesh)
    finally:
        cli.run_val, cli.VAL_FREQ = inner, freq
        PoseNetTrainer.train_step = step
    return {"step": state.step, "losses": losses, "steps": steps,
            "params": {k: v.detach().clone() for k, v in state.params.items()},
            "mu": dict(state.opt_state.mu), "nu": dict(state.opt_state.nu)}


def _case_config(base, accum):
    cfg = cli_config(str(base), epochs=STEPS - 1)
    cfg["train"]["grad_accum"] = accum
    cfg["train"]["batch_size"] *= accum
    return cfg


def _small_heads():
    """bench_train_step at 64x96: the heads cut to one UNet level (three
    need 384x512), as tests/test_torch_port_train_cli.py does."""
    from robust_pose_tpu_torch.models.posenet import PoseNet
    from robust_pose_tpu_torch.scripts import bench_train_step as bts
    from robust_pose_tpu_torch.train import trainer as T

    bts.H, bts.W = TRAIN_H, TRAIN_W
    T.PoseNet = lambda cfg, device=None: PoseNet({**cfg, "unet_levels": 1},
                                                 device=device)


def _rank(rank, addr, base, data, ckpt):
    """One rank: the CLI of each case into ``base/rank<r>/<case>``, then
    bench_train_step; results to ``base/rank<r>.pt``."""
    from robust_pose_tpu_torch.scripts import bench_train_step as bts

    torch.set_num_threads(2)
    res = {}
    with M.make_mesh("cpu", init_method=addr, rank=rank, world_size=WORLD,
                     timeout_s=120) as mesh:
        for case, accum in CASES.items():
            res[case] = _cli(["--name", "posenet", "--outpath",
                              os.path.join(base, f"rank{rank}", case),
                              "--restore_ckpt", ckpt],
                             _case_config(base, accum), data, mesh)
        _small_heads()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            res["bench"] = bts.main(["--batch", "2", "--steps", "1",
                                     "--skip_noremat"], mesh=mesh)
    res["printed"] = printed.getvalue()
    torch.save(res, os.path.join(base, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """World 2 in two spawned processes and world 1 here, from the same
    checkpoint and sequences."""
    from robust_pose_tpu_torch.data.train_datasets import get_data
    from robust_pose_tpu_torch.utils.checkpoints import save_checkpoint

    base = tmp_path_factory.mktemp("ddp_cli")
    write_sequence(base / "a")
    write_sequence(base / "b", keyframes=2, masks=False)
    write_sequence(base / "v")
    cfg = cli_config(str(base))
    sd = train_weights(seed=41)
    ckpt = str(base / "init")
    save_checkpoint(ckpt, sd, {"model": cfg["model"]})
    data = tuple(get_data(cfg["data"][k], cfg["image_shape"], cfg["depth_scale"])
                 for k in ("train", "val"))
    ctx = mp.start_processes(_rank, args=(M.free_tcp_address(), str(base),
                                          data, ckpt),
                             nprocs=WORLD, join=False, start_method="spawn")
    try:
        one = {case: _cli(["--name", "posenet", "--outpath",
                           str(base / "world1" / case), "--restore_ckpt", ckpt,
                           "--force_cpu"], _case_config(base, accum), data)
               for case, accum in CASES.items()}
        deadline = time.monotonic() + JOIN_S
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "workers did not finish"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    ranks = [torch.load(base / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return {"base": base, "sd": sd, "world1": one, "ranks": ranks}


@pytest.mark.parametrize("case", CASES)
def test_world2_cli_reads_the_world1_global_batches(runs, case):
    """At every step the ranks hold different rows, and put together in
    the JAX layout (of each microbatch, the ranks' shares in rank order)
    they are world 1's global batch bit for bit: one shuffled order, and
    each rank its own rows of every microbatch."""
    accum = CASES[case]
    one = runs["world1"][case]["steps"]
    r0, r1 = (r[case]["steps"] for r in runs["ranks"])
    assert len(one) == len(r0) == len(r1) == STEPS
    for s, a, b in zip(one, r0, r1):
        assert not np.array_equal(a["batch"][0], b["batch"][0])
        for want, x0, x1 in zip(s["batch"], a["batch"], b["batch"]):
            assert len(x0) == len(x1) == len(want) // WORLD == accum
            got = np.concatenate([np.split(x, accum)[i] for i in range(accum)
                                  for x in (x0, x1)])
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CASES)
def test_world2_cli_takes_the_world1_steps_and_validation(runs, case):
    """Both ranks take 2 steps and validate once, to the same metrics,
    loss and weights; each step's metrics, the validation loss and Adam's
    moments are world 1's within the module doc's bounds."""
    one, (r0, r1) = runs["world1"][case], (r[case] for r in runs["ranks"])
    assert one["step"] == r0["step"] == r1["step"] == STEPS
    assert len(one["losses"]) == len(r0["losses"]) == 1
    assert r0["losses"] == r1["losses"] and np.isfinite(one["losses"]).all()
    np.testing.assert_allclose(r0["losses"], one["losses"], rtol=RTOL)
    for s, a, b in zip(one["steps"], r0["steps"], r1["steps"]):
        assert a["metrics"] == b["metrics"]
        assert s["metrics"].keys() == a["metrics"].keys()
        for k, v in s["metrics"].items():
            np.testing.assert_allclose(a["metrics"][k], v, rtol=RTOL, err_msg=k)
    for k, v in r0["params"].items():
        assert torch.equal(v, r1["params"][k]), k
    for m in ("mu", "nu"):
        top = max(float(v.abs().max()) for v in one[m].values())
        for k, v in one[m].items():
            tol = RTOL * float(v.abs().max()) + 1e-6 * top
            np.testing.assert_allclose(r0[m][k].numpy(), v.numpy(), rtol=0,
                                       atol=tol, err_msg=f"{m} {k}")


@pytest.mark.parametrize("which", ["posenet", "posenet_last"])
@pytest.mark.parametrize("case", CASES)
def test_only_rank0_writes_checkpoints_that_a_world1_trainer_loads(
        runs, case, which):
    """Rank 0 writes the best and the last checkpoint, rank 1 nothing; the
    world-2 checkpoint loads into a world-1 trainer and holds world 1's
    weights within 2 lr a step plus 1e-4 of each leaf's largest value, RAFT
    bit for bit."""
    from robust_pose_tpu_torch.train.trainer import PoseNetTrainer
    from robust_pose_tpu_torch.utils.checkpoints import load_checkpoint_any

    base, sd = runs["base"], runs["sd"]
    assert sorted(os.listdir(base / "rank0" / case)) == ["posenet",
                                                         "posenet_last"]
    assert not os.path.exists(base / "rank1")
    got = load_checkpoint_any(str(base / "rank0" / case / which))["state_dict"]
    want = load_checkpoint_any(str(base / "world1" / case / which))["state_dict"]
    tr = PoseNetTrainer(_case_config(base, CASES[case]), device="cpu")
    st = tr.init_state(got)
    for k, w in want.items():
        g = got[k]
        assert torch.equal(tr.model.state_dict()[k], g), k
        if k.startswith("flow."):
            assert torch.equal(g, w) and torch.equal(g, sd[k]), k
            continue
        tol = 2 * LR * STEPS + 1e-4 * float(w.abs().max())
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=tol,
                                   err_msg=k)
    k = "weight_head_2d.unet.head.weight"
    assert not torch.equal(st.params[k].detach(), sd[k])


def test_bench_train_step_prints_each_ranks_ms(runs):
    """bench_train_step at world 2 (global batch 2, one row a rank): each
    rank prints and returns its own ms a step and the host ms of its
    ``train_step.allreduce`` span (no device ms on the CPU); peak memory is
    a card's figure (None here)."""
    for r, res in enumerate(runs["ranks"]):
        b = res["bench"]
        assert (b["rank"], b["world_size"], b["device"]) == (r, WORLD, "cpu")
        span = b["remat"]["allreduce_span"]
        assert b["remat"]["ms"] > 0 and span["host_ms"] > 0
        assert span["device_ms"] is None
        assert b["remat"]["peak_gib"] is None and "noremat" not in b
        assert f"rank {r}/{WORLD}: train step batch 2" in res["printed"]
        assert "train_step.allreduce span" in res["printed"]
