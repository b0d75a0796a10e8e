"""Weights (and a training state) from the JAX package's flax variables to
the port's state_dict.

The port's modules carry the flax module names, so a parameter's flax path
``a/b/c/kernel`` becomes ``a.b.c.weight``. Leaves may be numpy arrays or
anything ``np.asarray`` accepts; the JAX package itself is not imported.

* Conv kernel ``(kh, kw, I, O)`` -> weight ``(O, I, kh, kw)`` (this includes
  the 1x1 ``convc1``, whose input channels keep the JAX package's dy-major
  correlation-window order).
* ConvTranspose (``transpose_kernel=True``, the ``upconv*`` modules) kernel
  ``(kh, kw, O, I)`` -> weight ``(I, O, kh, kw)``.
* BatchNorm ``scale / bias`` -> ``weight / bias``; batch_stats ``mean /
  var`` -> ``running_mean / running_var`` (eps 1e-5 in both packages).
* ``convz*`` / ``convr*`` stay separate parameters.

``train_state_from_jax`` carries a JAX ``TrainState`` (params,
batch_stats, the optax Adam moments and count, the step) over with the same
rules, and ``surfel_state_from_jax`` a surfel map's state.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from robust_pose_tpu_torch.slam.surfel_map import SurfelState

_PARAM_NAMES = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_jax(variables) -> Dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` tree -> port ``state_dict``."""
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _walk(variables["params"]):
        arr = np.asarray(leaf, dtype=np.float32)
        *mods, leaf_name = path
        if not mods:                       # top-level parameter (loss_weight)
            sd[leaf_name] = torch.from_numpy(arr.copy())
            continue
        name = _PARAM_NAMES[leaf_name]
        if leaf_name == "kernel":
            # (kh, kw, I, O) -> (O, I, kh, kw) for a conv and, with the
            # same axis order, (kh, kw, O, I) -> (I, O, kh, kw) for upconv*
            arr = arr.transpose(3, 2, 0, 1)
        sd[".".join(mods + [name])] = torch.from_numpy(np.ascontiguousarray(arr))
    for path, leaf in _walk(variables.get("batch_stats", {})):
        *mods, leaf_name = path
        sd[".".join(mods + [_STAT_NAMES[leaf_name]])] = torch.from_numpy(
            np.asarray(leaf, dtype=np.float32).copy())
    return sd


def surfel_state_from_jax(state):
    """A JAX ``slam.surfel_map.SurfelState`` (leaves as numpy arrays or
    anything ``np.asarray`` takes) -> the port's ``SurfelState`` of CPU
    tensors with the same dtypes (f32 fields, int32 counters and
    ``t_created``, bool ``active``; ``tick``, ``n_dropped`` and ``hi`` 0-d)."""
    return SurfelState(*(torch.from_numpy(np.array(getattr(state, f)))
                         for f in SurfelState._fields))


def _adam_state(opt_state):
    """The optax ``ScaleByAdamState`` (fields count, mu, nu) inside a
    nested optimizer state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _adam_state(s)
            if found is not None:
                return found
    return None


def train_state_from_jax(state) -> dict:
    """JAX ``train.trainer.TrainState`` -> the dict
    ``robust_pose_tpu_torch.train.trainer.PoseNetTrainer.init_state``
    takes: ``state_dict``, Adam ``mu`` / ``nu`` by port parameter name (in
    the port's layouts), the optimizer ``count`` and the ``step``."""
    adam = _adam_state(state.opt_state)
    if adam is None:
        raise ValueError("train_state_from_jax: no Adam state in opt_state")
    return {
        "state_dict": params_from_jax({"params": state.params,
                                       "batch_stats": state.batch_stats}),
        "mu": params_from_jax({"params": adam.mu}),
        "nu": params_from_jax({"params": adam.nu}),
        "count": int(np.asarray(adam.count)),
        "step": int(np.asarray(state.step)),
    }
