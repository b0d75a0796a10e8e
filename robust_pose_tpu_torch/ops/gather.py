"""Row gathers, whole or chunk-serialized (port of
``robust_pose_tpu/ops/gather.py``).

``gather_rows(flat, idx)`` is ``flat[idx]`` over the leading axis, and
``gather_rows_batched`` the same per sample. The JAX module splits every
gather into serialized chunks of 65,536 rows by default: that answers a
TPU lowering problem (XLA's TPU gather slows down super-linearly with the
number of rows it gathers at once), which says nothing about the card. So
here ``chunk=None``, the default, is one ``index_select`` / ``torch.gather``;
an explicit ``chunk`` issues one gather per ``chunk`` rows into slices of
one preallocated output. On one CUDA stream the chunks run one after
another with no barrier between them. Whether chunking pays on the card is
what ``scripts/profile_warp4.py`` measures; the default changes only with
such a measurement.

Every chunk gives ``flat[idx]`` bit for bit, and gradients flow through
autograd's own backward of ``index_select`` / ``gather``.
"""
from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor


def _gather_into(out: Tensor, flat: Tensor, idx: Tensor, chunk: int) -> None:
    """``out[j:j + chunk] = flat[idx[j:j + chunk]]`` chunk by chunk. Under
    autograd a chunk is copied into its slice (``index_select`` with
    ``out=`` does not record a graph); otherwise it is written in place."""
    track = torch.is_grad_enabled() and flat.requires_grad
    for j in range(0, idx.shape[0], chunk):
        part = idx[j:j + chunk]
        if track:
            out[j:j + chunk] = flat.index_select(0, part)
        else:
            torch.index_select(flat, 0, part, out=out[j:j + chunk])


def gather_rows(flat: Tensor, idx: Tensor, chunk: Optional[int] = None) -> Tensor:
    """``flat[idx]`` row gather.

    :param flat: (M, C) or (M,) table
    :param idx: (N,) int32 or int64 row indices (0 <= idx < M)
    :param chunk: rows a gather; None: one gather
    :return: (N, C) or (N,) gathered rows
    """
    (n,) = idx.shape
    if chunk is None or n <= chunk:
        return flat.index_select(0, idx)
    out = flat.new_empty((n,) + tuple(flat.shape[1:]))
    _gather_into(out, flat, idx, chunk)
    return out


def gather_rows_batched(flat: Tensor, idx: Tensor,
                        chunk: Optional[int] = None) -> Tensor:
    """Per-sample ``gather_rows``: the chunks of sample b follow those of
    sample b - 1.

    :param flat: (B, M, C)
    :param idx: (B, N) int32 or int64 row indices
    :return: (B, N, C)
    """
    if chunk is None:
        return torch.gather(flat, 1, idx.long()[..., None].expand(
            -1, -1, flat.shape[-1]))
    out = flat.new_empty((idx.shape[0], idx.shape[1], flat.shape[-1]))
    for b in range(flat.shape[0]):
        _gather_into(out[b], flat[b], idx[b], chunk)
    return out
