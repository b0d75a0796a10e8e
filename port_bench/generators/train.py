"""Training: ``PoseNetTrainer.train_step`` on batches staged on the device,
its metrics read back every step, as the training CLI does.

Set-up builds the one trainer and state of the run and drives them through
the first ``check_steps`` steps (distinct batches, every row its own place
of the scene); what the comparison needs of those steps is kept then, and
the same trainer and state go on into the window. Mix keys: ``batch``,
``batches`` (staged and cycled), ``frame_steps``, ``step_px``,
``disparity_px`` (``traffic.train_batches``), ``check_steps`` and
``trace_steps``.
"""
from __future__ import annotations

import time

import torch

from port_bench import compare, traffic
from port_bench.reference import searched_convolutions
from port_bench.reference.model import ident
from port_bench.reference.train import B1, is_buffer, train_steps


def _norms(tensors: dict) -> dict:
    keys = list(tensors)
    vals = torch.stack([tensors[k].double().norm() for k in keys]).cpu()
    return dict(zip(keys, vals.tolist()))


class Generator:
    def __init__(self, cell):
        self.cell = cell
        self.cfg = cell.cfg
        self.mix = cell.mix
        self.dev = torch.device(cell.device)
        self.host = {}

    def setup(self, seconds: float, faults=None):
        """Inputs, the trainer and its state, and the checked steps;
        ``faults(self)`` may break the trainer before it steps (tests)."""
        from robust_pose_tpu_torch.train.trainer import PoseNetTrainer

        cfg, mix = self.cfg, self.mix
        H, W = cfg["image_shape"]
        self.B = mix["batch"]
        self.weights = traffic.weights(self.cell.seed, cfg, self.dev)
        self.batches = traffic.train_batches(
            self.cell.seed, mix["batches"], self.B, H, W, mix, cfg, self.dev)
        job = {k: cfg[k] for k in ("model", "train", "image_shape")}
        self.trainer = PoseNetTrainer(job, device=self.dev)
        self.state = self.trainer.init_state(
            variables={k: v.clone() for k, v in self.weights.items()})
        if faults is not None:
            faults(self)
        self.step_no = 0
        prog = {"loss": [], "grad_norm": [], "sample_loss": []}
        forward = self.trainer._forward

        def capture(*a, **k):               # the steps' per-sample losses
            loss = forward(*a, **k)
            prog["sample_loss"].append(loss.detach().sum(-1))
            return loss

        update = self.trainer.optimizer.update

        def capture_grads(params, grads, state):    # before the freeze
            if "first_grad" not in prog:
                zero = torch.zeros((), device=self.dev)
                prog["first_grad"] = _norms({k: zero if g is None else g
                                             for k, g in grads.items()})
            return update(params, grads, state)

        self.trainer._forward = capture
        self.trainer.optimizer.update = capture_grads
        for s in range(mix["check_steps"]):
            m = self._step()
            prog["loss"].append(m["train/loss_total"])
            prog["grad_norm"].append(m["train/grad_norm"])
            if s == 0:
                mu = self.state.opt_state.mu
                prog["first_update"] = _norms({k: v / (1 - B1) for k, v in mu.items()})
        self.trainer._forward = forward
        self.trainer.optimizer.update = update
        sd = self.trainer.model.state_dict()
        prog["change"] = _norms({k: sd[k] - self.weights[k] for k in sd
                                 if not is_buffer(k)})
        prog["bn_change"] = _norms({k: sd[k] - self.weights[k] for k in sd
                                    if is_buffer(k) and k.startswith("weight_head")})
        self.prog = prog

    def _step(self) -> dict:
        batch = self.batches[self.step_no % len(self.batches)]
        self.step_no += 1
        self.state, m = self.trainer.train_step(self.state, batch)
        vals = torch.stack([v.float() for v in m.values()]).cpu().tolist()
        return dict(zip(m, vals))

    def window(self, seconds: float) -> dict:
        """Samples a second over every step of the window."""
        steps = failed = 0
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < seconds:
            m = self._step()
            steps += 1
            failed += not all(map(lambda v: v == v, m.values()))
        wall = time.perf_counter() - t_start
        self.attempted, self.failed = steps, failed
        self.rate = self.B * steps / wall
        return {"train_samples_per_s": self.rate}

    def trace_fn(self):
        def run():
            for _ in range(self.mix["trace_steps"]):
                self._step()
            return self.mix["trace_steps"]
        return run

    def work(self) -> dict:
        """One step's work: 3B RAFT pairs ((1l, 1r), (2l, 2r), (1l, 2l)),
        4B images through the feature encoder, 2B through the context
        encoder, B pairs of heads, and the backward of all of it: the job
        as ``train.yaml`` reads keeps RAFT's gradients live."""
        B = self.B
        return {"pairs": 3 * B, "fnet": 4 * B, "cnet": 2 * B, "heads": B,
                "backward": True, "per_rate": B}

    def release(self):
        self.trainer = self.state = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, q=ident, batches=None):
        """The reference's first ``check_steps`` steps from the same weights
        over the same batches, reduced to the numbers compared."""
        n = self.mix["check_steps"]
        with searched_convolutions():
            ref = train_steps(self.weights, self.cfg, batches or self.batches[:n],
                              n, q)
        w = ref["weights"]
        return {"loss": ref["loss"], "grad_norm": ref["grad_norm"],
                "sample_loss": ref["sample_loss"],
                "first_update": _norms(ref["first_update"]),
                "first_grad": _norms(ref["first_grad"]),
                "change": _norms({k: w[k] - self.weights[k] for k in w
                                  if not is_buffer(k)}),
                "bn_change": _norms({k: w[k] - self.weights[k] for k in w
                                     if is_buffer(k) and k.startswith("weight_head")})}

    def check(self) -> dict:
        return compare.train_numbers(self.prog, self.reference())
