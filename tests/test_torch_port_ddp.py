"""Data parallelism of the port on the CPU (``parallel/mesh.py``, the heads'
global BatchNorm statistics, the averaged gradients, the global batch's
dropout masks and metrics): two gloo processes, spawned once for the
module, each holding its half of every global batch; world 1 is the
port's trainer without a mesh, in one process, on the whole batch.

Every case of ``_cases`` runs two steps at world 2. Each step is then
replayed at world 1 from the state world 2 held before it (the initial
weights, then world 2's state after its first step), so each comparison
is of one step from one state.

Tolerances: the two ranks' states bit for bit. World 2 against world 1,
the JAX-parity bound 2e-3: the per-sample LM iteration counts move
between the two (the frozen case's first step takes 23 and 4 iterations
at world 1, 13 and 23 at world 2: the batch-1 convolutions and the
statistics summed over ranks round otherwise, and the f32 LM stops on
the last bits of its steps), and the poses they reach differ by up to
~5e-4 of the loss in the live cases. So loss and metrics rtol 2e-3;
every gradient within 2e-3 of its leaf's largest plus 2e-5 of the
largest of all (a leaf whose gradient is rounding noise: a convolution
bias that a BatchNorm cancels); Adam's moments within 2e-3 of the leaf's
largest plus 1e-6 of the largest of all; parameters within 2e-3 of the
leaf's largest where the gradient is above twice its tolerance (elsewhere
Adam's first step, ~lr * sign(g), follows rounding) and within 2 lr
everywhere. The heads' BatchNorm running statistics, computed before the
solve, rtol 1e-4. The negative control (the heads' BatchNorm on each
rank's statistics) misses these bounds by far.
"""
import copy
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from robust_pose_tpu_torch.parallel import mesh as M
from tests.test_torch_port_common import (  # noqa: F401 (fixture)
    assert_step_matches,
    jax_grads_from_first_step,
    jax_variables,
    random_state_dict,
    train_batch,
    train_config,
    train_weights,
    two_torch_threads,
)

WORLD = 2
RTOL = 2e-3                   # the JAX-parity bound (see the module doc)
STATS_RTOL = 1e-4
LR = train_config()["train"]["learning_rate"]
JOIN_S = 300                  # the workers' deadline; a collective times out at 120 s

pytestmark = pytest.mark.usefixtures("two_torch_threads")


def _cases():
    """name -> (config, global batch, the heads' BatchNorm on each rank's
    own statistics): RAFT frozen (stop_flow_grad), live, grad_accum 2 at
    global batch 4, dropout 0.1 with RAFT live, and the negative control."""
    live = train_config(freeze_flow_steps=0)
    drop = copy.deepcopy(live)
    drop["model"]["dropout"] = 0.1
    return {"frozen": (train_config(), 2, False),
            "live": (live, 2, False),
            "accum": (train_config(grad_accum=2), 4, False),
            "dropout": (drop, 2, False),
            "local_stats": (train_config(), 2, True)}


def _trainer(cfg, start, mesh):
    """The port's trainer from ``start`` (a state_dict, or a train state
    dict), on the CPU or on ``mesh``, recording the gradients its optimizer
    receives."""
    from robust_pose_tpu_torch.train.trainer import PoseNetTrainer

    tr = (PoseNetTrainer(cfg, device="cpu") if mesh is None
          else PoseNetTrainer(cfg, mesh=mesh))
    st = tr.init_state(start)
    tr.seen = []
    update = tr.optimizer.update

    def spy(params, grads, opt_state):
        tr.seen.append({k: None if g is None else g.clone()
                        for k, g in grads.items()})
        return update(params, grads, opt_state)

    tr.optimizer.update = spy
    return tr, st


def _step(tr, st, batch):
    """One train step; what it reported and the state after it."""
    st, m = tr.train_step(st, batch)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "iters": tr.last_solver_iters.tolist(), "grads": tr.seen[-1],
            "state": {"state_dict": {**{k: v.detach().clone()
                                        for k, v in st.params.items()},
                                     **{k: v.clone()
                                        for k, v in st.batch_stats.items()}},
                      "mu": {k: v.clone() for k, v in st.opt_state.mu.items()},
                      "nu": {k: v.clone() for k, v in st.opt_state.nu.items()},
                      "count": st.opt_state.count, "step": st.step}}


def _rank(rank, addr, cases, sd, out):
    """One rank: every case at world 2 (this rank's rows of each global
    batch, the collectives counted a step), then its share of the world-1
    replays; all saved to ``out/rank<r>.pt``."""
    torch.set_num_threads(2)
    res = {}
    with M.make_mesh("cpu", init_method=addr, rank=rank, world_size=WORLD,
                     timeout_s=120) as mesh:
        for name, (cfg, batches, local) in cases.items():
            tr, st = _trainer(cfg, sd, mesh)
            if local:
                forward = tr.model.forward
                tr.model.forward = lambda *a, mesh=None, **kw: forward(*a, **kw)
            accum = cfg["train"].get("grad_accum", 1)
            steps = []
            for b in batches:
                mesh.calls.clear()
                steps.append(_step(tr, st, M.shard_batch(mesh, b, accum)))
                steps[-1]["calls"] = dict(mesh.calls)
            res[name] = steps
    replays = [n for n, (_, _, local) in cases.items() if not local]
    for name in replays[rank::WORLD]:
        cfg, batches, _ = cases[name]
        res[name + "/world1"] = []
        for k, b in enumerate(batches):
            tr, st = _trainer(cfg, sd if k == 0 else res[name][k - 1]["state"],
                              None)
            res[name + "/world1"].append(_step(tr, st, b))
    torch.save(res, f"{out}/rank{rank}.pt")


def _jax_step(sd, batch):
    """The JAX trainer's first step on a 2-device mesh (conftest's virtual
    CPU devices) from ``sd``, frozen configuration."""
    from robust_pose_tpu.parallel.mesh import make_mesh, replicate
    from robust_pose_tpu.train.trainer import PoseNetTrainer as JTrainer

    mesh = make_mesh(2)
    tr = JTrainer(train_config(), mesh=mesh)
    st = replicate(mesh, tr.init_state(jax.random.PRNGKey(0),
                                       variables=jax_variables(sd)))
    with jax.default_matmul_precision("float32"):
        st1, m = tr.make_train_step()(st, batch)
    return st1, m


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks' results of every case, the world-1 replays, and the JAX
    step on a 2-device mesh (computed here while the workers run)."""
    out = tmp_path_factory.mktemp("ddp")
    sd = train_weights()
    cases = {n: (cfg, [train_batch(seed=s, b=b) for s in (1, 2)], local)
             for n, (cfg, b, local) in _cases().items()}
    ctx = mp.start_processes(_rank, args=(M.free_tcp_address(), cases, sd,
                                          str(out)),
                             nprocs=WORLD, join=False, start_method="spawn")
    try:
        jst1, jm = _jax_step(sd, cases["frozen"][1][0])
        deadline = time.monotonic() + JOIN_S
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "workers did not finish"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    ranks = [torch.load(f"{out}/rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    world1 = {k: v for r in ranks for k, v in r.items() if k.endswith("/world1")}
    return {"sd": sd, "cases": cases, "ranks": ranks, "world1": world1,
            "jax": (jst1, jm)}


def _close(ref, got, rtol=RTOL, stats_rtol=STATS_RTOL):
    """Which quantities of step ``got`` miss those of ``ref`` (the module
    doc's bounds); empty when the steps agree."""
    bad = []
    for k, v in ref["metrics"].items():
        if abs(got["metrics"][k] - v) > rtol * abs(v):
            bad.append(k)
    gmax = max(float(g.abs().max()) for g in ref["grads"].values()
               if g is not None)
    mmax = {m: max(float(v.abs().max()) for v in ref["state"][m].values())
            for m in ("mu", "nu")}
    for k, g in ref["grads"].items():
        if g is None:
            assert got["grads"][k] is None, k
            continue
        tol = rtol * float(g.abs().max()) + 2e-5 * gmax
        if float((got["grads"][k] - g).abs().max()) > tol:
            bad.append("grad " + k)
        for m in ("mu", "nu"):
            a, b = ref["state"][m][k], got["state"][m][k]
            if float((a - b).abs().max()) > rtol * float(a.abs().max()) + 1e-6 * mmax[m]:
                bad.append(f"{m} {k}")
        p, q = ref["state"]["state_dict"][k], got["state"]["state_dict"][k]
        d = (p - q).abs()
        big = g.abs() > 2 * tol
        if float(d.max()) > 2 * LR or (
                bool(big.any()) and float(d[big].max()) > rtol * float(p.abs().max())):
            bad.append("param " + k)
    for k, v in ref["state"]["state_dict"].items():
        if k.endswith(("running_mean", "running_var")):
            w = got["state"]["state_dict"][k]
            if float((v - w).abs().max()) > stats_rtol * float(v.abs().max()):
                bad.append("stats " + k)
    return bad


@pytest.mark.parametrize("case", ["frozen", "live", "accum", "dropout"])
def test_ranks_hold_the_same_state_after_each_step(runs, case):
    """Weights, BatchNorm statistics, Adam moments, count, step and
    metrics bit for bit on both ranks after each step."""
    r0, r1 = (r[case] for r in runs["ranks"])
    for a, b in zip(r0, r1):
        assert a["metrics"] == b["metrics"] and a["iters"] == b["iters"]
        assert a["state"]["count"] == b["state"]["count"]
        for part in ("state_dict", "mu", "nu"):
            for k, v in a["state"][part].items():
                assert torch.equal(v, b["state"][part][k]), (part, k)


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("case", ["frozen", "live", "accum", "dropout"])
def test_world2_step_equals_world1_step(runs, case, step):
    """A step at world 2 against the world-1 step on the whole global batch
    from the same state (module doc's bounds); the ranks' gathered LM
    counts cover the global batch."""
    ref = runs["world1"][case + "/world1"][step]
    got = runs["ranks"][0][case][step]
    assert got["state"]["step"] == ref["state"]["step"] == step + 1
    assert len(got["iters"]) == len(ref["iters"])
    assert _close(ref, got) == []


@pytest.mark.parametrize("case", ["frozen", "live", "accum"])
def test_collectives_a_step(runs, case):
    """The collectives a step: one all-reduce a heads' BatchNorm in the
    forward and one in the backward of each microbatch (one UNet level:
    one BatchNorm in each of the two heads), one gradient bucket, and two
    gathers (the per-sample losses and the LM counts)."""
    accum = runs["cases"][case][0]["train"].get("grad_accum", 1)
    for s in runs["ranks"][0][case]:
        assert s["calls"] == {"all_reduce_sum": 2 * 2 * accum,
                              "mean_bucket": 1, "all_gather_rows": 2}


def test_local_statistics_differ(runs):
    """The negative control: the same world-2 step with the heads'
    BatchNorm on each rank's own statistics (1 row a rank) misses the
    world-1 step by more than the tolerance, in its running statistics,
    gradients and gradient norm: the comparison sees a missing
    all-reduce."""
    ref = runs["world1"]["frozen/world1"][0]
    bad = _close(ref, runs["ranks"][0]["local_stats"][0])
    assert any(b.startswith("stats ") for b in bad)
    assert any(b.startswith("grad ") for b in bad)
    assert "train/grad_norm" in bad


def test_world2_matches_the_jax_trainer_on_a_2_device_mesh(runs):
    """World 2's first frozen step against the JAX trainer's SPMD step on
    a 2-device mesh, as tests/test_torch_port_train_frozen.py holds world
    1 (grad_rtol 2e-3)."""
    jst1, jm = runs["jax"]
    got = runs["ranks"][0]["frozen"][0]
    sd = runs["sd"]
    stats = {k: v for k, v in got["state"]["state_dict"].items()
             if k.endswith(("running_mean", "running_var"))}
    params = {k: v for k, v in got["state"]["state_dict"].items()
              if k not in stats}
    assert_step_matches({"sd": sd, "jm": jm, "pm": got["metrics"],
                         "jst1": jst1,
                         "pst": types.SimpleNamespace(params=params,
                                                      batch_stats=stats),
                         "jgrads": jax_grads_from_first_step(jst1, jm, 1.0),
                         "pgrads": got["grads"]}, grad_rtol=2e-3)


def test_world1_mesh_goes_through_the_collectives_bit_for_bit(tmp_path):
    """A world of 1 with a process group (gloo, in this process) runs the
    all-reduces and gathers and gives the trainer's bits without a mesh:
    the statistics divided by 1 and summed over one rank, the gradients
    averaged over one rank."""
    cfg, sd, batch = train_config(), train_weights(), train_batch(seed=1)
    ref = _step(*_trainer(cfg, sd, None), batch)
    with M.make_mesh("cpu", init_method=M.free_tcp_address(), rank=0,
                     world_size=1, timeout_s=60) as mesh:
        got = _step(*_trainer(cfg, sd, mesh), batch)
        assert mesh.calls["all_reduce_sum"] == 4 and mesh.calls["mean_bucket"] == 1
    assert got["metrics"] == ref["metrics"] and got["iters"] == ref["iters"]
    for part in ("state_dict", "mu", "nu"):
        for k, v in ref["state"][part].items():
            assert torch.equal(v, got["state"][part][k]), (part, k)


def test_dropout_masks_are_the_global_batch_rows():
    """Each rank's encoder masks are its rows of each block of the global
    batch's masks, as PoseNet.forward indexes them (4 blocks through fnet,
    the first 2 through cnet): the same channels zeroed as in one pass over
    the whole batch, the kept ones equal."""
    from robust_pose_tpu_torch.models.raft import RAFT

    raft = RAFT(iters=1, small=True, dropout=0.3, dtype=torch.float32,
                corr_dtype=torch.float32)
    raft.load_state_dict(random_state_dict(raft, seed=4))
    rng = np.random.default_rng(3)
    b, blocks = 4, 4
    img = torch.from_numpy(rng.uniform(0, 255, (blocks * b, 32, 48, 3))
                           .astype(np.float32))
    gen = lambda: torch.Generator().manual_seed(11)
    with torch.no_grad():
        whole = raft.encode_fnet(img, True, gen()).view(blocks, b, -1)
        whole_c = raft.encode_cnet(img[:2 * b], True, gen())[1].view(2, b, -1)
        for r in range(WORLD):
            own = torch.as_tensor(M.batch_sharding(
                M.Mesh(WORLD, r, torch.device("cpu")), b))
            idx = torch.cat([k * b + own for k in range(blocks)])
            part = raft.encode_fnet(img[idx], True, gen(), (blocks * b, idx))
            part_c = raft.encode_cnet(img[idx[:2 * len(own)]], True, gen(),
                                      (2 * b, idx[:2 * len(own)]))[1]
            for got, want, n in ((part, whole, blocks), (part_c, whole_c, 2)):
                want = want.view(n, WORLD, b // WORLD, -1)[:, r]
                got = got.view(n, b // WORLD, -1)
                assert torch.equal(got == 0, want == 0)
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("accum", [1, 2, 4])
def test_shard_batch_rows_follow_the_jax_layout(accum):
    """Rank r holds, of each microbatch of JAX's reshape
    ``(accum, B / accum)``, its r-th contiguous share; numpy arrays and
    tensors alike."""
    B = 8
    x = np.arange(B * 3).reshape(B, 3)
    micro = np.asarray(jnp.reshape(jnp.asarray(x), (accum, B // accum, 3)))
    for r in range(WORLD):
        mesh = M.Mesh(WORLD, r, torch.device("cpu"))
        want = np.concatenate([np.split(m, WORLD)[r] for m in micro])
        got_np, got_t = M.shard_batch(mesh, (x, torch.from_numpy(x)), accum)
        np.testing.assert_array_equal(got_np, want)
        np.testing.assert_array_equal(got_t.numpy(), want)
    one = M.Mesh(1, 0, torch.device("cpu"))
    assert M.shard_batch(one, (x,), accum)[0] is x


def test_mesh_refusals(monkeypatch):
    """Refused before any process group is made: a batch not divisible by
    grad_accum x world size; a world of 2 without an address; a LOCAL_RANK
    beyond the cards (never wrapped onto card 0); NCCL asked for two ranks
    on one card; NCCL on the CPU."""
    mesh = M.Mesh(WORLD, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        M.shard_batch(mesh, (np.zeros((6, 1)),), accum=2)
    with pytest.raises(ValueError, match="not divisible"):
        M.batch_sharding(mesh, 3)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="init_method"):
        M.make_mesh("cpu", world_size=2)
    addr = "tcp://127.0.0.1:1"
    monkeypatch.setenv("LOCAL_RANK", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 2 has no card"):
        M.make_mesh(init_method=addr, rank=0, world_size=4)
    monkeypatch.delenv("LOCAL_RANK")
    with pytest.raises(ValueError, match="one rank a card"):
        M.make_mesh("cuda:0", init_method=addr, rank=1, world_size=2,
                    backend="nccl")
    with pytest.raises(ValueError, match="nccl needs a CUDA device"):
        M.make_mesh("cpu", init_method=addr, rank=0, world_size=1,
                    backend="nccl")
    assert not torch.distributed.is_initialized()
