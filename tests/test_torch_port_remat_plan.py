"""The trainer's remat default (``train.trainer.plan_remat``): RAFT is
recomputed in the backward pass only where a training step without remat
would not fit on the card.

On the CPU, with the card's free memory injected (``torch.cuda.mem_get_info``
patched; the model itself is built on the CPU): each case of the rule;
``PoseNet.saved_bytes`` against the bytes
``torch.autograd.graph.saved_tensors_hooks`` records in a no-remat training
forward at 64x96; span ``raft.remat`` counting the checkpointed calls.

The card test (``-m card``) runs ``port_bench``'s ``train`` configuration
(512x640, batch 8) three steps with the default and with ``remat: true``
under deterministic algorithms and holds the states, losses and gradient
norms to each other bit for bit (without them the card's atomic adds make
two runs of one configuration differ at about 5e-5 in the weights). This file
imports no JAX, so on a machine without it the card test runs apart from
the suite's conftest: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_port_remat_plan.py -m card``.
"""
import copy
import json
from pathlib import Path

import pytest
import torch

from robust_pose_tpu_torch.parallel.mesh import Mesh
from robust_pose_tpu_torch.scripts import bench
from robust_pose_tpu_torch.scripts import bench_train_step as bts
from robust_pose_tpu_torch.train.trainer import (
    REMAT_FIT,
    PoseNetTrainer,
    plan_remat,
)
from robust_pose_tpu_torch.utils import profiling

H, W, B = 64, 96, 4
CARD = torch.device("cuda", 0)
HUGE = 1 << 50
# PoseNet.saved_bytes against the saved tensors' storages
ESTIMATE_RTOL = 0.05


@pytest.fixture(autouse=True)
def fresh():
    """Every test starts from an empty span recorder, on two threads."""
    profiling.reset()
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    profiling.reset()


@pytest.fixture()
def card():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with python -m pytest "
                    "--noconftest tests/test_torch_port_remat_plan.py -m card")
    return CARD


def _config(model=None, train=None):
    """64x96, 2 GRU iterations, one UNet level, batch 4, RAFT's gradients
    live (``freeze_flow_steps`` given)."""
    return {"model": {"iters": 2, "lbgfs_iters": 20, "use_weights": True,
                      "unet_levels": 1, "dropout": 0.0, "small": False,
                      **(model or {})},
            "image_shape": [H, W],
            "train": {"batch_size": B, "learning_rate": 1e-5,
                      "weight_decay": 5e-5, "epsilon": 1e-8, "grad_clip": 1.0,
                      "freeze_flow_steps": 10 ** 18, **(train or {})}}


def _plan(monkeypatch, cfg, free=HUGE, device=CARD, mesh=None):
    """``plan_remat`` for ``cfg``'s model (built on the CPU by the trainer)
    as it would run on ``device`` with ``free`` bytes free there."""
    model = PoseNetTrainer(cfg, device="cpu").model
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (free, 80 << 30))
    return plan_remat(model, cfg, torch.device(device), mesh)


def _mesh(backend):
    return Mesh(2, 0, CARD, group=object(), backend=backend)


# (model keys, train keys, device, mesh backend or None, free memory as a
# share of the reference need's margin (need / REMAT_FIT), remat expected,
# need reckoned)
CASES = {
    "fits": ({}, {}, "cuda", None, 1.001, False, True),
    "does_not_fit": ({}, {}, "cuda", None, 0.999, True, True),
    "explicit_true": ({"remat": True}, {}, "cuda", None, 100.0, True, False),
    "explicit_false": ({"remat": False}, {}, "cuda", None, 0.01, False, False),
    "cpu": ({}, {}, "cpu", None, 0.01, False, False),
    "stop_flow_grad": ({}, {"stop_flow_grad": True}, "cuda", None, 0.01, False,
                       False),
    "grad_accum_2": ({}, {"grad_accum": 2}, "cuda", None, 0.999, False, True),
    "two_ranks_one_card": ({}, {}, "cuda", "gloo", 0.999, True, True),
    "two_ranks_two_cards": ({}, {}, "cuda", "nccl", 0.999, False, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_remat_default_follows_memory(case, monkeypatch):
    """A no-remat step that fits under ``REMAT_FIT`` of the free memory runs
    without remat and one that does not keeps it; an explicit
    ``model.remat`` wins; the CPU and ``stop_flow_grad`` keep it off;
    ``grad_accum`` 2 reckons with half the batch; ranks that may share a
    card (gloo) share its free memory, NCCL's one rank a card does not."""
    model, train, device, backend, share, remat, reckoned = CASES[case]
    ref = _plan(monkeypatch, _config()).need_bytes
    mesh = None if backend is None else _mesh(backend)
    cfg = _config(model, train)
    free = int(share * ref / REMAT_FIT)
    plan = _plan(monkeypatch, cfg, free, device, mesh)
    assert plan.remat is remat
    if not reckoned:
        assert plan.need_bytes is None and plan.free_bytes is None
        return
    assert plan.free_bytes == (free // 2 if backend == "gloo" else free)
    if model or train or backend:
        # half the rows of one microbatch: the need of batch B / 2, whose
        # activations (the need less the gradients and moments) are about
        # half the reference's
        half = _plan(monkeypatch, _config(train={"batch_size": B // 2}))
        state = 3 * sum(p.numel() * 4 for p in
                        PoseNetTrainer(cfg, device="cpu").model.parameters())
        assert plan.need_bytes == half.need_bytes
        assert plan.need_bytes - state < 0.6 * (ref - state)
    else:
        assert plan.need_bytes == ref


def test_trainer_records_its_plan_and_sets_raft():
    """The trainer keeps the plan and runs RAFT by it: off on the CPU,
    an explicit ``remat: true`` on."""
    tr = PoseNetTrainer(_config(), device="cpu")
    assert not tr.remat_plan.remat and not tr.model.flow.remat
    assert tr.model.config["remat"] is False
    tr = PoseNetTrainer(_config({"remat": True}), device="cpu")
    assert tr.remat_plan.remat and tr.model.flow.remat


def _saved_tensor_bytes(trainer, data):
    """Bytes of the storages autograd saves in a training forward, each
    once, the parameters left out."""
    params = {p.untyped_storage().data_ptr() for p in trainer.model.parameters()}
    seen = {}

    def pack(t):
        s = t.untyped_storage()
        if s.data_ptr() not in params:
            seen[s.data_ptr()] = s.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        trainer._forward(data, train=True)
    return sum(seen.values())


@pytest.mark.parametrize("model", [{}, {"mixed_precision": False},
                                   {"small": True}, {"lookup": "lanewise"},
                                   {"lookup": "onthefly"}],
                         ids=["large_bf16", "large_f32", "small_bf16",
                              "lanewise", "onthefly"])
def test_saved_bytes_estimate_matches_saved_tensors(model, monkeypatch):
    """``PoseNet.saved_bytes`` lies within ``ESTIMATE_RTOL`` of what a
    no-remat training forward at 64x96 saves: through the ``"xla"`` lookup
    the trainer takes with RAFT's gradients live, and through K4/K5's and
    K1's plain versions."""
    trainer = PoseNetTrainer(_config(model), device="cpu")
    monkeypatch.setattr(bts, "H", H)
    monkeypatch.setattr(bts, "W", W)
    data = trainer._nhwc_batch(bts.make_batch(2, key=1, device="cpu"))
    measured = _saved_tensor_bytes(trainer, data)
    assert trainer.model.saved_bytes(2) == pytest.approx(measured,
                                                         rel=ESTIMATE_RTOL)


@pytest.mark.parametrize("case", ["train_remat", "train_no_remat",
                                  "infer_window_remat"])
def test_raft_remat_span_counts_checkpointed_calls(case, monkeypatch):
    """Span ``raft.remat`` counts the encoders and the ``iters`` GRU
    iterations of a RAFT pass under remat, and nothing without it or under
    ``torch.no_grad``."""
    if case == "infer_window_remat":
        monkeypatch.setattr(bench, "H", H)
        monkeypatch.setattr(bench, "W", W)
        monkeypatch.setattr(bench, "MODEL", dict(bench.MODEL, iters=2,
                                                 unet_levels=1))
        est = bench.build_estimator(dict(bench.F2F_SLAM), device="cpu")
        est.model.flow.remat = True
        windows, masks = bench.start_stream(est, 2, 1)
        est.track_window(windows[0][0], windows[0][1], masks)
        assert profiling.span_totals("infer_window.flow")[0] == 1
        assert profiling.span_totals("raft.remat")[0] == 0
        return
    remat = case == "train_remat"
    tr = PoseNetTrainer(_config({"remat": remat}, {"batch_size": 2}),
                        device="cpu")
    state = tr.init_state(seed=0)
    monkeypatch.setattr(bts, "H", H)
    monkeypatch.setattr(bts, "W", W)
    tr.train_step(state, bts.make_batch(2, key=1, device="cpu"))
    assert profiling.span_totals("train_step")[0] == 1
    assert profiling.span_totals("raft.remat")[0] == (2 + 2 if remat else 0)


# --- on the card ---------------------------------------------------------------

STEPS = 3


def _card_run(dev, remat):
    """``STEPS`` steps of port_bench's ``train`` configuration from the
    benchmark's seeded weights over its staged batches; returns the
    trainer's plan, the final state, every step's metrics, the span
    ``raft.remat``'s calls a step and the peak allocated over what the
    trainer and its inputs held before the first step."""
    from port_bench import traffic

    root = Path(__file__).resolve().parents[1] / "port_bench"
    cfg = json.loads((root / "configs" / "train.json").read_text())
    mix = json.loads((root / "mixes" / "b8.json").read_text())
    job = copy.deepcopy({k: cfg[k] for k in ("model", "train", "image_shape")})
    if remat is not None:
        job["model"]["remat"] = remat
    h, w = cfg["image_shape"]
    weights = traffic.weights(7, cfg, dev)
    batches = traffic.train_batches(7, STEPS, mix["batch"], h, w, mix, cfg, dev)
    tr = PoseNetTrainer(job, device=dev)
    state = tr.init_state(variables={k: v.clone() for k, v in weights.items()})
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    profiling.reset()
    metrics = []
    for batch in batches:
        state, m = tr.train_step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated(dev) - base
    out = {"plan": tr.remat_plan, "metrics": metrics, "peak": peak,
           "remat_calls": profiling.span_totals("raft.remat")[0] / STEPS,
           "state": {"params": {k: v.detach().cpu() for k, v in state.params.items()},
                     "mu": {k: v.cpu() for k, v in state.opt_state.mu.items()},
                     "nu": {k: v.cpu() for k, v in state.opt_state.nu.items()}}}
    del tr, state, weights, batches
    torch.cuda.empty_cache()
    return out


@pytest.fixture()
def deterministic(monkeypatch):
    """Deterministic algorithms for the test (cuBLAS with a fixed
    workspace, cuDNN's deterministic kernels, no op that adds with
    atomics), restored after."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cudnn = torch.backends.cudnn
    before = (torch.are_deterministic_algorithms_enabled(), cudnn.deterministic,
              cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    cudnn.deterministic, cudnn.benchmark = True, False
    yield
    torch.use_deterministic_algorithms(before[0])
    cudnn.deterministic, cudnn.benchmark = before[1:]


@pytest.mark.card
def test_default_step_equals_remat_on_the_card(card, deterministic):
    """At batch 8 and 512x640 the default resolves to no remat (span
    ``raft.remat`` 0 calls a step, 2 + 12 with ``remat: true``) and peaks
    within the plan's estimate, which lies under ``REMAT_FIT`` of the free
    memory; under deterministic algorithms its three steps give the
    states, losses and gradient norms of three steps under remat bit for
    bit: the same operations, recomputed."""
    default = _card_run(card, None)
    remat = _card_run(card, True)
    plan = default["plan"]
    assert not plan.remat and default["remat_calls"] == 0
    assert remat["plan"].remat and remat["remat_calls"] == 2 + 12
    assert default["peak"] <= plan.need_bytes <= REMAT_FIT * plan.free_bytes
    assert remat["peak"] < default["peak"]
    assert default["metrics"] == remat["metrics"]
    for group, leaves in default["state"].items():
        for k, v in leaves.items():
            assert torch.equal(v, remat["state"][group][k]), (group, k)
