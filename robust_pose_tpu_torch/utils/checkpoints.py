"""Checkpoints of the port (counterpart of
``robust_pose_tpu/utils/checkpoints.py``).

* A weights checkpoint is a directory: ``checkpoint.pt`` (``torch.save`` of
  the port's ``state_dict``) and ``config.json`` (the config, as the JAX
  package writes it). :func:`load_checkpoint` returns ``{'state_dict',
  'config'}``, the dict ``slam.pose_estimator.PoseEstimator`` takes. It also
  reads a directory that the JAX package's ``save_checkpoint`` wrote
  (``checkpoint.msgpack``, flax's serialization of the variable tree): a
  reader of the msgpack subset flax writes is part of this module, and the
  tree is mapped with ``utils.convert.params_from_jax``.
* :func:`load_checkpoint_any` takes either kind of directory or a reference
  ``.pth`` (``utils.torch_convert.convert_posenet_pth``).
* A training state (:func:`save_train_state`, :func:`load_train_state`) is
  a directory holding ``train_state.pt``: the weights, the BatchNorm
  statistics, Adam's ``mu`` / ``nu`` / ``count`` and the step, read back
  as the dict ``PoseNetTrainer.init_state`` resumes from.

Only files this program or the JAX package wrote are unpickled, with
``weights_only=True``.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict

import numpy as np
import torch

from robust_pose_tpu_torch.utils.convert import params_from_jax

WEIGHTS_FILE = "checkpoint.pt"
JAX_WEIGHTS_FILE = "checkpoint.msgpack"
CONFIG_FILE = "config.json"
TRAIN_STATE_FILE = "train_state.pt"


# --- flax's msgpack ------------------------------------------------------------

def _array_from_ext(data: bytes) -> np.ndarray:
    """flax's ndarray encoding: a msgpack (shape, dtype name, C-order bytes)."""
    shape, name, buf = msgpack_restore(data)
    if name == "bfloat16":        # numpy has no bfloat16: widen to f32, exact
        bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
        arr = bits.view(np.float32)
    else:
        arr = np.frombuffer(buf, dtype=np.dtype(name)).copy()   # writable
    return arr.reshape(tuple(shape))


# type byte -> struct format of the length that follows, by kind
_BIN = {0xC4: "B", 0xC5: "H", 0xC6: "I"}
_STR = {0xD9: "B", 0xDA: "H", 0xDB: "I"}
_ARRAY = {0xDC: "H", 0xDD: "I"}
_MAP = {0xDE: "H", 0xDF: "I"}
_EXT = {0xC7: "B", 0xC8: "H", 0xC9: "I"}
# type byte -> struct format of the number that follows
_NUM = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
        0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
_CONST = {0xC0: None, 0xC2: False, 0xC3: True}


class _Reader:
    """Decoder of the msgpack subset flax writes: nil, bool, int, float,
    str, bin, array, map and ext types 1 (ndarray) and 3 (numpy scalar)."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return out

    def num(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def ext(self, n: int):
        code = self.num("b")
        payload = self.take(n)
        if code == 1:
            return _array_from_ext(payload)
        if code == 3:
            return _array_from_ext(payload)[()]
        raise ValueError(f"msgpack: ext type {code} is not a flax array")

    def value(self):
        t = self.num("B")
        if t <= 0x7F:                          # positive fixint
            return t
        if t >= 0xE0:                          # negative fixint
            return t - 0x100
        if t <= 0x8F:                          # fixmap
            return self.map(t & 0x0F)
        if t <= 0x9F:                          # fixarray
            return [self.value() for _ in range(t & 0x0F)]
        if t <= 0xBF:                          # fixstr
            return self.take(t & 0x1F).decode()
        if t in _CONST:
            return _CONST[t]
        if t in _NUM:
            return self.num(_NUM[t])
        if t in _BIN:
            return self.take(self.num(_BIN[t]))
        if t in _STR:
            return self.take(self.num(_STR[t])).decode()
        if t in _ARRAY:
            return [self.value() for _ in range(self.num(_ARRAY[t]))]
        if t in _MAP:
            return self.map(self.num(_MAP[t]))
        if t in _EXT:
            return self.ext(self.num(_EXT[t]))
        if 0xD4 <= t <= 0xD8:                  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (t - 0xD4))
        raise ValueError(f"msgpack: unknown type byte 0x{t:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def _unchunk(tree):
    """flax splits arrays above 1 GiB into ``__msgpack_chunked_array__``
    dicts; join them back."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes):
    """flax.serialization.msgpack_restore without msgpack or flax: the tree
    of dicts with numpy array leaves."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("msgpack: trailing bytes")
    return _unchunk(tree)


# --- weights ---------------------------------------------------------------

def save_checkpoint(path: str, state_dict: Dict[str, torch.Tensor],
                    config: Dict) -> None:
    """Write ``{state_dict, config}`` to the directory ``path``."""
    os.makedirs(path, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()},
               os.path.join(path, WEIGHTS_FILE))
    with open(os.path.join(path, CONFIG_FILE), "w") as f:
        json.dump(config, f, indent=2)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read a checkpoint directory, the port's or the JAX package's.

    :return: ``{'state_dict': CPU tensors by the port's names, 'config'}``
    """
    with open(os.path.join(path, CONFIG_FILE)) as f:
        config = json.load(f)
    port = os.path.join(path, WEIGHTS_FILE)
    if os.path.exists(port):
        sd = torch.load(port, map_location="cpu", weights_only=True)
    else:
        jax_file = os.path.join(path, JAX_WEIGHTS_FILE)
        if not os.path.exists(jax_file):
            raise FileNotFoundError(f"{path}: neither {WEIGHTS_FILE} nor "
                                    f"{JAX_WEIGHTS_FILE}")
        with open(jax_file, "rb") as f:
            sd = params_from_jax(msgpack_restore(f.read()))
    return {"state_dict": sd, "config": config}


def load_checkpoint_any(path: str) -> Dict[str, Any]:
    """A checkpoint directory (the port's or the JAX package's) or a
    reference torch ``.pth`` / ``.pt`` file, as ``{'state_dict', 'config'}``."""
    if os.path.isdir(path):
        return load_checkpoint(path)
    if path.endswith((".pth", ".pt")):
        from robust_pose_tpu_torch.utils.torch_convert import convert_posenet_pth
        return convert_posenet_pth(path)
    raise ValueError(f"unrecognized checkpoint: {path}")


# --- training state ---------------------------------------------------------------

def save_train_state(path: str, state) -> None:
    """Write a ``train.trainer.TrainState`` to the directory ``path``:
    weights and BatchNorm statistics (one state_dict), Adam's moments and
    count, and the step; all tensors copied to the CPU."""
    os.makedirs(path, exist_ok=True)
    cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}
    torch.save({"state_dict": {**cpu(state.params), **cpu(state.batch_stats)},
                "mu": cpu(state.opt_state.mu), "nu": cpu(state.opt_state.nu),
                "count": int(state.opt_state.count), "step": int(state.step)},
               os.path.join(path, TRAIN_STATE_FILE))


def load_train_state(path: str) -> Dict[str, Any]:
    """Read what :func:`save_train_state` wrote: the dict
    ``PoseNetTrainer.init_state(variables=...)`` resumes from (the form of
    ``utils.convert.train_state_from_jax``), tensors on the CPU."""
    return torch.load(os.path.join(path, TRAIN_STATE_FILE), map_location="cpu",
                      weights_only=True)
