"""PoseNet training CLI (port of ``scripts/train_posenet.py``).

Supervised tangent-space pose training over the sequences of a config,
with the RAFT freeze, validation every ``VAL_FREQ`` steps, the best and
the last checkpoint by validation loss, and a stop when the validation
loss is NaN::

    python -m robust_pose_tpu_torch.scripts.train_posenet \\
        --config configuration/train.yaml --outpath output [--restore_ckpt X]

It runs on one CUDA card unless ``--force_cpu`` is given (without a card
and without it, it raises). Data-parallel over N cards, as the JAX CLI
shards over its mesh::

    torchrun --nproc_per_node N -m robust_pose_tpu_torch.scripts.train_posenet \
        --config configuration/train.yaml --outpath output

Every rank shuffles the one sample order (the same seed) and reads its
rows of each global batch (``parallel.mesh.batch_sharding``); the steps
are the one-process steps on the global batch (``train.trainer``). Rank 0
alone prints, logs and writes checkpoints; the NaN stop reads the global
validation loss, so every rank stops at the same step. ``main`` reads the
datasets from disk (``get_data``); ``run`` is the loop, for datasets from
anywhere, and takes a mesh made by the caller (worker processes without
torchrun).
"""
import argparse
import os

import numpy as np
import torch

SUM_FREQ = 100
VAL_FREQ = 1000


def _collate(samples):
    return tuple(np.stack([s[i] for s in samples]) for i in range(9))


def _batches(dataset, batch_size, rng=None, shuffle=False, rows=None):
    """Global batches of ``batch_size`` in (shuffled) order; of each, the
    ``rows`` this rank holds (all without)."""
    idx = np.arange(len(dataset))
    if shuffle:
        rng.shuffle(idx)
    for i in range(0, len(idx) - batch_size + 1, batch_size):
        take = idx[i:i + batch_size]
        if rows is not None:
            take = take[rows]
        yield _collate([dataset[j] for j in take])


class _NoLog:
    """The logger of ranks other than 0: rank 0 logs for the world."""

    def push(self, *args, **kwargs):
        pass

    flush = save_model = close = push


def _on_device(batches, device, timer):
    """The batches of the prefetch thread, uploaded to ``device``; stage
    ``data`` times the wait for each batch and its upload."""
    it = iter(batches)
    while True:
        with timer.stage("data"):
            batch = next(it, None)
            if batch is None:
                return
            batch = tuple(torch.from_numpy(x).to(device) for x in batch)
        yield batch


def run_val(trainer, state, data_val, batch_size, logger, rows=None):
    """The mean validation loss over ``data_val`` (NaN without a batch);
    under a mesh each batch is read as this rank's ``rows`` and its loss
    is the global batch's."""
    from robust_pose_tpu_torch.data.dataset_utils import prefetch_iterator

    losses = []
    for batch in prefetch_iterator(_batches(data_val, batch_size, rows=rows)):
        m = trainer.val_step(state, batch)
        logger.push({k: float(v) for k, v in m.items() if k != "val/loss"},
                    max(len(data_val) // batch_size, 1), "val")
        losses.append(float(m["val/loss"]))
    logger.flush("val")
    return float(np.mean(losses)) if losses else float("nan")


def _save(args, config, trainer, logger, best):
    """The last checkpoint, and the best one where ``best``."""
    from robust_pose_tpu_torch.utils.checkpoints import save_checkpoint

    weights = trainer.model.state_dict()
    if best:
        path = os.path.join(args.outpath, args.name)
        save_checkpoint(path, weights, config)
        logger.save_model(path)
    save_checkpoint(os.path.join(args.outpath, f"{args.name}_last"), weights,
                    config)


def _device(args) -> torch.device:
    from robust_pose_tpu_torch.device import resolve_device

    return resolve_device("cpu" if args.force_cpu else None)


def main(args, config):
    from robust_pose_tpu_torch.data.train_datasets import get_data

    _device(args)          # no card and no --force_cpu: raise before reading
    data_train = get_data(config["data"]["train"], config["image_shape"],
                          config["depth_scale"])
    data_val = get_data(config["data"]["val"], config["image_shape"],
                        config["depth_scale"])
    return run(args, config, data_train, data_val)


def run(args, config, data_train, data_val, timer=None, mesh=None):
    """The training loop over ``data_train`` with validation on
    ``data_val``. ``timer``: a ``StageTimer`` to fill (stages ``data``: the
    wait for a batch and its upload, ``step``, ``log``: the metrics read
    back, ``val``: validation and checkpoints). ``mesh``: this rank's
    ``parallel.mesh.Mesh`` (default ``make_mesh`` on the CLI's device:
    torchrun's world, else a world of 1; the loop leaves a mesh it made).
    ``train.batch_size`` must divide by ``grad_accum`` x world size and
    ``val.batch_size`` by the world size. Returns the final
    ``TrainState``."""
    from robust_pose_tpu_torch.parallel.mesh import make_mesh

    own = mesh is None
    mesh = make_mesh("cpu" if args.force_cpu else None) if own else mesh
    try:
        return _run(args, config, data_train, data_val, timer, mesh)
    finally:
        if own:
            mesh.close()


def _run(args, config, data_train, data_val, timer, mesh):
    from robust_pose_tpu_torch.data.dataset_utils import prefetch_iterator
    from robust_pose_tpu_torch.parallel.mesh import batch_sharding
    from robust_pose_tpu_torch.train.trainer import PoseNetTrainer
    from robust_pose_tpu_torch.utils.checkpoints import load_checkpoint_any
    from robust_pose_tpu_torch.utils.logging import TrainLogger
    from robust_pose_tpu_torch.utils.profiling import StageTimer

    device = mesh.device
    lead = mesh.rank == 0
    timer = StageTimer() if timer is None else timer
    config["model"]["image_shape"] = config["image_shape"]
    batch_size = config["train"]["batch_size"]
    rows = batch_sharding(mesh, batch_size,
                          int(config["train"].get("grad_accum", 1)))
    val_rows = batch_sharding(mesh, config["val"]["batch_size"])
    rng = np.random.default_rng(1234)
    if lead:
        print(f"train: {len(data_train)} samples, val: {len(data_val)} "
              f"samples, world size {mesh.world_size}")

    freeze_flow = config["train"].get("freeze_flow_steps", 1) > 0
    trainer = PoseNetTrainer(config, freeze_flow=freeze_flow, mesh=mesh)

    variables = None
    pretrained = config["model"].get("pretrained")
    if pretrained and os.path.isfile(pretrained):
        # RAFT warm start: random heads, RAFT's weights and buffers from a
        # reference .pth
        from robust_pose_tpu_torch.utils.torch_convert import convert_raft_pth

        trainer.model.reset_parameters(torch.Generator().manual_seed(1234))
        variables = trainer.model.state_dict()
        variables.update({"flow." + k: v
                          for k, v in convert_raft_pth(pretrained).items()})
    if args.restore_ckpt:
        variables = load_checkpoint_any(args.restore_ckpt)["state_dict"]
    state = trainer.init_state(variables, seed=1234)

    logger = TrainLogger(config, args.name, args.log) if lead else _NoLog()
    if lead:
        os.makedirs(args.outpath, exist_ok=True)

    total_steps = 0
    best_loss = 1e6
    should_keep_training = True
    while should_keep_training:
        # the next batches are read and collated on a background thread
        # while the device runs the current step
        batches = prefetch_iterator(
            _batches(data_train, batch_size, rng, shuffle=True, rows=rows))
        for batch in _on_device(batches, device, timer):
            with timer.stage("step"):
                state, metrics = trainer.train_step(state, batch)
            with timer.stage("log"):
                logger.push({k: float(v) for k, v in metrics.items()}, SUM_FREQ)
                if total_steps % SUM_FREQ == SUM_FREQ - 1:
                    logger.flush()

            if total_steps % VAL_FREQ == 0:
                with timer.stage("val"):
                    val_loss = run_val(trainer, state, data_val,
                                       config["val"]["batch_size"], logger,
                                       val_rows)
                    if np.isnan(val_loss):
                        should_keep_training = False
                        break
                    if lead:
                        _save(args, config, trainer, logger,
                              val_loss < best_loss)
                    best_loss = min(best_loss, val_loss)
            total_steps += 1
            if total_steps > config["train"]["epochs"]:
                should_keep_training = False
                break
        if len(data_train) < batch_size:
            break

    logger.close()
    return state


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--name", default="RAFT-poseEstimator",
                        help="name your experiment")
    parser.add_argument("--outpath", default="output", help="output path")
    parser.add_argument("--log", action="store_true")
    parser.add_argument("--restore_ckpt",
                        help="restore checkpoint: a checkpoint directory (this "
                        "package's or the JAX package's) or a reference .pth")
    parser.add_argument("--config", help="yaml config file",
                        default=os.path.join(os.path.dirname(__file__), "..",
                                             "..", "configuration",
                                             "train.yaml"))
    parser.add_argument("--force_cpu", action="store_true",
                        help="run on the CPU (the plain versions of the "
                        "kernels); without it the run needs a CUDA card")
    parser.add_argument("--dbg", action="store_true")
    return parser


if __name__ == "__main__":
    from robust_pose_tpu_torch.utils.config import read_yaml

    args = build_parser().parse_args()
    np.random.seed(1234)
    main(args, read_yaml(args.config))
