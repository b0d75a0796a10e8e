"""Each cell end to end on the CPU at a tiny size, through the program's
plain kernel versions: the result line, the reference's agreement with
the program, and ``correct`` coming out false for each fault the cell can
have and for the lower-precision control."""
import json
from pathlib import Path

import pytest
import torch

from port_bench import cells, control, run
from port_bench.tests.conftest import SMALL

ROOT = Path(__file__).resolve().parents[2]
BENCH = cells.benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2 ** 31 + 977            # larger than 32 signed bits hold
CPU = torch.device("cpu")
# the program in f32 on the CPU against the reference: rounding, and for
# the poses the LM's step tolerance (1e-6) against the small motions of a
# 64x96 frame
AGREE = {"flow_px": 1e-4, "depth_rel": 1e-5, "conf": 1e-5, "rel_pose": 1e-2,
         "flags": 0.0, "chain": 1e-2, "loss": 1e-3, "grad_norm": 1e-3,
         "first_update": 1e-2, "change": 1e-2, "bn_stats": 1e-4,
         "sample_loss": 1e-3, "first_update_median": 1e-3, "change_median": 1e-3,
         "unmoved_moved": 0.0, "chain_breaks": 0.0, "raft_grad": 1e-2,
         "raft_grad_median": 1e-3, "solve_pose": 1e-2}


def small(workload):
    return SMALL[next(w["config"] for w in BENCH["workloads"]
                      if w["name"] == workload)]


def run_small(workload, trace=False, faults=None):
    return run.run_cell(workload, SEED, 1.0, trace, CPU, ROOT,
                        small(workload), faults)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_and_agrees(workload):
    r = run_small(workload, trace=True)
    readings = r.pop("readings")        # main prints these on stderr
    line = json.loads(json.dumps(r))
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert set(line) <= {"correct", "attempted", "failed", "metrics", "device",
                         "breakdown", "checks"}
    assert list(line)[-1] == "checks"
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["device"]["platform"] == "cpu"
    for k, v in [*((k, v) for k, (v, _) in line["checks"].items()),
                 *readings.items()]:
        assert v <= AGREE[k], (k, v)
    # on the CPU no device metric is read
    cell = cells.load_cell(BENCH, workload, SEED, CPU)
    assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert all(m["source"] == "host_clock" for m in BENCH["per_layer"]
               if m["name"] in line["metrics"])


def _alter_answer(drv):
    """The window's depth map 1 % off where it is produced."""
    infer = drv.est.model.infer_window

    def altered(*a, **k):
        out = infer(*a, **k)
        return out._replace(depth2=out.depth2 * 1.01)
    drv.est.model.infer_window = altered


def _stale_state(drv):
    """Each window returns the estimator's state unchanged: the next
    window starts from the same pose, frame and features."""
    est = drv.est
    track = est.track_window

    def stale(*a, **k):
        kept = (est.last_pose, est.frame, est._feats)
        out = track(*a, **k)
        est.last_pose, est.frame, est._feats = kept
        return out
    est.track_window = stale


def _solve_cut(drv):
    """The pose solve stopped after two of its iterations."""
    model = drv.est.model
    model.solver_cfg = model.solver_cfg._replace(iters=2)


def _unchanged_state(drv):
    trainer = drv.trainer

    def unchanged(state, batch):
        saved = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
        count = state.opt_state.count
        mu = {k: v.clone() for k, v in state.opt_state.mu.items()}
        nu = {k: v.clone() for k, v in state.opt_state.nu.items()}
        state, m = type(trainer).train_step(trainer, state, batch)
        trainer.model.load_state_dict(saved)
        state.opt_state.count = count
        for d, s in ((state.opt_state.mu, mu), (state.opt_state.nu, nu)):
            for k in d:
                d[k].copy_(s[k])
        return state, m
    trainer.train_step = unchanged


def _half_batch(drv):
    trainer = drv.trainer
    nhwc = trainer._nhwc_batch

    def half(batch):
        return [x[:x.shape[0] // 2] for x in nhwc(batch)]
    trainer._nhwc_batch = half


def _raft_backward_skipped(drv):
    """RAFT's backward left out: its gradients never reach the optimizer."""
    drv.trainer.model.config["stop_flow_grad"] = True


FAULTS = {"stream": [_alter_answer, _stale_state, _solve_cut],
          "train": [_unchanged_state, _half_batch, _raft_backward_skipped]}


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in CELLS
    for f in FAULTS[cells.load_cell(BENCH, w, 1, CPU).mix["generator"]]],
    ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_fault_is_not_correct(workload, fault):
    """The run's own path, with the program broken underneath before it
    first runs, reads as not correct under the cell's limits."""
    r = run_small(workload, faults=fault)
    assert r["correct"] is False, r["checks"]
    assert any(v > lim for v, lim in r["checks"].values()), r["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    """The reference in float8 in the program's place fails the cell's
    limits at the tiny size too."""
    r = control.readings(workload, SEED, 1.0, CPU, ROOT, True, small(workload))
    limits = cells.load_cell(BENCH, workload, SEED, CPU).limits
    assert any(r["control"][k] > lim for k, lim in limits.items()), r["control"]
    assert all(v <= AGREE[k] for k, v in r["program"].items())
