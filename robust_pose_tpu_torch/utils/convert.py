"""Weights from the JAX package's flax variables to the port's state_dict.

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
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

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
