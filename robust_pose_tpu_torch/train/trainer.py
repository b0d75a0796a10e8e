"""PoseNet training (port of ``robust_pose_tpu/train/trainer.py``): the
optimizer chain, the RAFT freeze schedule, gradient accumulation, the
train/val steps and their data-parallel meaning.

* Optimizer: optax's ``chain(clip_by_global_norm(grad_clip),
  adamw(learning_rate, weight_decay, epsilon))`` written out: the update is
  scaled by ``max_norm / |g|`` only when ``|g| >= max_norm``; AdamW keeps
  ``eps`` outside the square root and decays the weights decoupled from
  the moments.
* Freeze: while ``count < freeze_flow_steps`` (or forever when that key is
  absent) the RAFT (``flow.*``) gradients are zeroed before the chain and
  their updates after it. There is ONE step count for every parameter, so
  after an unfreeze the RAFT moments ramp from zero under the shared bias
  correction, as the JAX package's ``_freeze_until`` does
  (``torch.optim.AdamW`` would keep a count per parameter and skip
  parameters without a gradient).
* The model defaults of the JAX trainer: ``stop_flow_grad`` when RAFT is
  frozen for the whole run, ``remat`` on the card when RAFT gradients are
  live, and ``lookup`` "auto" (on-the-fly) with ``stop_flow_grad``, else
  "xla"; each can be set in the model config.
* ``train.grad_accum`` splits the batch into microbatches run in order
  (the heads' BatchNorm statistics chain through them) and averages their
  gradients.
* Dropout (``model.dropout`` > 0): each forward of step s draws its masks
  from a ``torch.Generator`` on the model's device seeded from
  (``DROPOUT_SEED``, s), as the JAX trainer folds the step into
  ``PRNGKey(1234)``: every microbatch of a step gets the same stream, and a
  resumed run draws what the uninterrupted one would. The bits differ from
  JAX's; the distribution is the same.
* Data parallelism (``mesh``: a ``parallel.mesh.Mesh`` with a process
  group): each rank holds its rows of the global batch
  (``parallel.mesh.shard_batch``, the JAX trainer's layout under
  ``grad_accum``) and the step is the one-process step on the whole batch,
  as the JAX SPMD step is: the heads' BatchNorm takes the global batch's
  statistics, dropout the global (micro)batch's masks (this rank's rows),
  the gradients are averaged over ranks in one flat all-reduce (span
  ``train_step.allreduce``) and then divided by ``grad_accum``, and the
  metrics, ``val/loss`` and ``last_solver_iters`` are the global batch's,
  gathered in the JAX package's row order. ``init_state`` broadcasts the
  state from rank 0, so the ranks' states stay bit-equal.
* Resume: ``init_state(variables=utils.checkpoints.load_train_state(path))``
  restores the weights, BatchNorm statistics, Adam moments, count and step.

The parameters, BatchNorm statistics and optimizer moments are updated in
place: a ``TrainState`` holds the model's own tensors. BatchNorm follows
the ``train`` argument of ``PoseNet.forward`` (as flax's
``use_running_average`` does), not the module's train/eval flag.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch.profiler import record_function

from robust_pose_tpu_torch.device import resolve_device
from robust_pose_tpu_torch.models.posenet import PoseNet
from robust_pose_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_rows,
    mean_bucket,
    replicate,
)
from robust_pose_tpu_torch.train.losses import loss_metrics, supervised_pose_loss

Tensor = torch.Tensor

DROPOUT_SEED = 1234       # the JAX trainer's PRNGKey(1234)


@dataclasses.dataclass
class OptState:
    count: int                    # optimizer steps taken, shared by all
    mu: Dict[str, Tensor]         # Adam first moments by parameter name
    nu: Dict[str, Tensor]         # Adam second moments


@dataclasses.dataclass
class TrainState:
    params: Dict[str, Tensor]       # the model's parameters
    batch_stats: Dict[str, Tensor]  # the model's BatchNorm running statistics
    opt_state: OptState
    step: int


class AdamWClip:
    """Global-norm clip + AdamW with the RAFT freeze (see the module
    docstring); Adam's decay rates are optax's defaults."""

    b1, b2 = 0.9, 0.999

    def __init__(self, learning_rate, weight_decay, eps, max_norm,
                 frozen=frozenset(), freeze_steps=None):
        self.lr, self.wd, self.eps = learning_rate, weight_decay, eps
        self.max_norm = max_norm
        self.frozen = frozenset(frozen)
        self.freeze_steps = freeze_steps   # None: frozen forever

    def init(self, params: Dict[str, Tensor]) -> OptState:
        return OptState(0, {k: torch.zeros_like(p) for k, p in params.items()},
                        {k: torch.zeros_like(p) for k, p in params.items()})

    @torch.no_grad()
    def update(self, params: Dict[str, Tensor], grads: Dict[str, Optional[Tensor]],
               state: OptState) -> OptState:
        """One step, in place on ``params`` and ``state``; a missing
        gradient (None) counts as zero."""
        frozen = (self.frozen if self.freeze_steps is None
                  or state.count < self.freeze_steps else frozenset())
        g = {k: (torch.zeros_like(p) if grads.get(k) is None or k in frozen
                 else grads[k]) for k, p in params.items()}
        gnorm = global_norm(g.values())
        if not bool(gnorm < self.max_norm):
            g = {k: (v / gnorm) * self.max_norm for k, v in g.items()}
        state.count += 1
        one = torch.ones((), dtype=torch.float32)
        bc1 = float(one - torch.tensor(self.b1) ** state.count)
        bc2 = float(one - torch.tensor(self.b2) ** state.count)
        for k, p in params.items():
            mu = state.mu[k].mul_(self.b1).add_((1 - self.b1) * g[k])
            nu = state.nu[k].mul_(self.b2).add_((1 - self.b2) * (g[k] * g[k]))
            if k in frozen:
                continue
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps) + self.wd * p
            p.add_(-self.lr * u)
        return state


def global_norm(tensors) -> Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


def make_optimizer(train_cfg: Dict, params: Dict[str, Tensor],
                   freeze_flow: bool = True) -> AdamWClip:
    """The JAX package's ``make_optimizer``: RAFT parameters frozen for the
    first ``freeze_flow_steps`` steps (forever when the key is absent)."""
    frozen = {k for k in params if k.startswith("flow.")} if freeze_flow else ()
    return AdamWClip(train_cfg.get("learning_rate", 1e-5),
                     train_cfg.get("weight_decay", 5e-5),
                     train_cfg.get("epsilon", 1e-8),
                     train_cfg.get("grad_clip", 1.0), frozen,
                     train_cfg.get("freeze_flow_steps", None))


class PoseNetTrainer:
    """Train and validation steps of a PoseNet on one device, or on one
    rank of a data-parallel ``mesh``.

    :param config: the training config (``configuration/train.yaml``
        layout: model / train / image_shape keys)
    :param device: ``cuda`` unless given (``device="cpu"`` for the plain
        versions); the mesh's device when a mesh is given
    :param mesh: a ``parallel.mesh.Mesh``; with a process group the steps
        take this rank's rows of each global batch (see the module doc)
    """

    def __init__(self, config: Dict, freeze_flow: bool = True, device=None,
                 mesh: Optional[Mesh] = None):
        self.config = config
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            device = mesh.device
        self.device = resolve_device(device)
        # the collectives run only with a process group (world 1 included)
        self.mesh = mesh if mesh is not None and mesh.distributed else None
        self._train_cfg = config["train"]
        model_cfg = dict(config["model"])
        model_cfg["image_shape"] = tuple(config["image_shape"])
        stop_flow = self._train_cfg.get(
            "stop_flow_grad",
            freeze_flow and self._train_cfg.get("freeze_flow_steps") is None)
        model_cfg.setdefault("stop_flow_grad", stop_flow)
        model_cfg.setdefault("remat", self.device.type == "cuda"
                             and not model_cfg["stop_flow_grad"])
        model_cfg.setdefault("lookup",
                             "auto" if model_cfg["stop_flow_grad"] else "xla")
        self.model = PoseNet(model_cfg, device=self.device)
        self.freeze_flow = freeze_flow
        self.optimizer = None  # built on init_state
        self.last_solver_iters = None  # (B,) realized LM iterations, last batch

    def init_state(self, variables: Optional[Dict] = None,
                   seed: int = 0) -> TrainState:
        """A fresh state: random weights from ``seed``, or ``variables``:
        a port ``state_dict``, or the dict of
        ``utils.convert.train_state_from_jax`` and
        ``utils.checkpoints.load_train_state`` (weights, optimizer moments,
        count and step)."""
        m = self.model
        full = variables is not None and "state_dict" in variables
        if variables is None:
            m.reset_parameters(torch.Generator().manual_seed(seed))
        else:
            m.load_state_dict(variables["state_dict"] if full else variables)
        params = dict(m.named_parameters())
        stats = {k: b for k, b in m.named_buffers()
                 if k.endswith(("running_mean", "running_var"))}
        self.optimizer = make_optimizer(self._train_cfg, params,
                                        self.freeze_flow)
        opt = self.optimizer.init(params)
        step = 0
        if full:
            opt = OptState(int(variables["count"]),
                           {k: v.to(self.device).clone()
                            for k, v in variables["mu"].items()},
                           {k: v.to(self.device).clone()
                            for k, v in variables["nu"].items()})
            step = int(variables["step"])
        if self.mesh is not None:
            # rank 0's weights, statistics and moments on every rank
            replicate(self.mesh, [*params.values(), *stats.values(),
                                  *opt.mu.values(), *opt.nu.values()])
        return TrainState(params, stats, opt, step)

    def _nhwc_batch(self, batch):
        """Datasets emit NCHW images and masks; the model takes NHWC."""
        img1, img2, img1r, img2r, mask1, mask2, gt, K, bl = (
            torch.as_tensor(x).to(self.device) for x in batch)
        t = lambda x: x.permute(0, 2, 3, 1)
        return (t(img1).float(), t(img2).float(), t(img1r).float(),
                t(img2r).float(), t(mask1).bool(), t(mask2).bool(),
                gt.float(), K.float(), bl.float())

    def dropout_generator(self, step: int):
        """The generator of step ``step``'s dropout masks (None without
        dropout)."""
        if self.model.flow.dropout <= 0.0:
            return None
        g = torch.Generator(device=self.device)
        return g.manual_seed((DROPOUT_SEED << 32) + int(step))

    def _forward(self, batch, train: bool, step: int = 0):
        img1, img2, img1r, img2r, mask1, mask2, gt, K, bl = batch
        out = self.model(img1, img2, K, bl, img1r, img2r, mask1, mask2,
                         train=train,
                         dropout_generator=self.dropout_generator(step)
                         if train else None, mesh=self.mesh)
        self.last_solver_iters = out.solver_iters
        return supervised_pose_loss(out.pose_tan, gt)

    def _global_rows(self, rows: Tensor) -> Tensor:
        """Per-sample rows (accum, B / (accum W), ...) of this rank -> the
        global batch's (B, ...) in the JAX trainer's order: microbatch by
        microbatch, each in rank order."""
        if self.mesh is None:
            return rows.reshape(-1, *rows.shape[2:])
        w, (accum, m) = self.mesh.world_size, rows.shape[:2]
        every = all_gather_rows(self.mesh, rows)       # (W * accum, m, ...)
        return every.view(w, accum, m, *rows.shape[2:]).transpose(0, 1).reshape(
            -1, *rows.shape[2:])

    def train_step(self, state: TrainState, batch):
        """One optimizer step; updates ``state`` in place and returns
        ``(state, metrics)`` with ``train/loss_rot``, ``train/loss_trans``,
        ``train/loss_total`` and ``train/grad_norm`` (of the averaged
        gradients, before the freeze and the clip). Under a mesh ``batch``
        is this rank's rows of the global batch and every output is the
        global batch's."""
        accum = int(self._train_cfg.get("grad_accum", 1))
        batch = self._nhwc_batch(batch)
        b = batch[0].shape[0]
        if b % accum:
            raise ValueError(f"batch {b} not divisible by grad_accum {accum}")
        for p in state.params.values():
            p.grad = None
        losses = []
        # profiler spans of the step's stages (chip_smoke.py's train_profile
        # reads them); outside a profiler they cost microseconds
        for i in range(accum):
            mb = [x[i * b // accum:(i + 1) * b // accum] for x in batch]
            with record_function("train_step.forward"):
                loss_pose = self._forward(mb, train=True, step=state.step)
            with record_function("train_step.backward"):
                loss_pose.mean().backward()
            losses.append(loss_pose.detach())
        # the parameters with a gradient: the same set on every rank
        live = [k for k, p in state.params.items() if p.grad is not None]
        summed = [state.params[k].grad for k in live]
        if self.mesh is not None:
            with record_function("train_step.allreduce"):
                summed = mean_bucket(self.mesh, summed)
        with record_function("train_step.update"):
            grads = dict.fromkeys(state.params)
            grads.update({k: g / accum for k, g in zip(live, summed)})
            metrics = loss_metrics(self._global_rows(torch.stack(losses)),
                                   "train")
            metrics["train/grad_norm"] = global_norm(
                g for g in grads.values() if g is not None)
            self.optimizer.update(state.params, grads, state.opt_state)
            if self.mesh is not None:
                self.last_solver_iters = self._global_rows(
                    self.last_solver_iters[None])
        for p in state.params.values():
            p.grad = None
        state.step += 1
        return state, metrics

    @torch.no_grad()
    def val_step(self, state: TrainState, batch) -> Dict[str, Tensor]:
        """Validation metrics of a batch (under a mesh: this rank's rows;
        the metrics and ``val/loss``, a nanmean, are the global batch's)."""
        loss_pose = self._global_rows(
            self._forward(self._nhwc_batch(batch), train=False)[None])
        if self.mesh is not None:
            self.last_solver_iters = self._global_rows(
                self.last_solver_iters[None])
        m = loss_metrics(loss_pose, "val")
        m["val/loss"] = torch.nanmean(loss_pose)
        return m
