"""Reference-format torch checkpoints onto the port's ``state_dict`` (the
port's twin of ``robust_pose_tpu/utils/torch_convert.py``).

The reference's RAFT (``raft-things.pth``) and PoseNet checkpoints
(``{'state_dict', 'config'}``) already hold torch layouts, so the mapping is
one of names: RAFT's ``layer1.0`` becomes ``layer1_0``, a residual block's
``downsample.0`` / ``downsample.1`` become ``downsample`` / ``norm3``, the
update block's ``mask.0`` / ``mask.2`` become ``up_mask.mask_conv1`` /
``mask_conv2``, a TinyUNet's ``0.encoder.enc_blocks.i`` becomes
``unet.enc<i>`` (the decoder alike), and BatchNorm's ``num_batches_tracked``
is dropped. One entry changes its values' order: ``convc1``'s input
channels. Upstream RAFT samples its window with ``delta = meshgrid(dy,
dx)``, whose first component displaces x, so the checkpoint's channels are
x-offset-major while the port's lookups emit y-offset-major windows
(``_permute_corr_window``).

Like the JAX converter this maps RAFT's large variant only; a checkpoint of
the small one raises.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

Tensor = torch.Tensor


def strip_module_prefix(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Remove DataParallel ``module.`` prefixes."""
    return {k.replace("module.", ""): v for k, v in state_dict.items()}


def _f32(v) -> Tensor:
    return torch.as_tensor(v).detach().to(torch.float32).contiguous().clone()


def _conv(out: Dict, sd: Dict, src: str, dst: str) -> None:
    out[f"{dst}.weight"] = _f32(sd[f"{src}.weight"])
    if f"{src}.bias" in sd:
        out[f"{dst}.bias"] = _f32(sd[f"{src}.bias"])


def _bn(out: Dict, sd: Dict, src: str, dst: str) -> None:
    for name in ("weight", "bias", "running_mean", "running_var"):
        out[f"{dst}.{name}"] = _f32(sd[f"{src}.{name}"])


def _encoder(out, sd, src: str, dst: str, norm: str) -> None:
    """BasicEncoder (fnet: instance norm, no parameters; cnet: BatchNorm)."""
    _conv(out, sd, f"{src}.conv1", f"{dst}.conv1")
    _conv(out, sd, f"{src}.conv2", f"{dst}.conv2")
    if norm == "batch":
        _bn(out, sd, f"{src}.norm1", f"{dst}.norm1")
    for li in (1, 2, 3):
        for bi in (0, 1):
            s, d = f"{src}.layer{li}.{bi}", f"{dst}.layer{li}_{bi}"
            _conv(out, sd, f"{s}.conv1", f"{d}.conv1")
            _conv(out, sd, f"{s}.conv2", f"{d}.conv2")
            if norm == "batch":
                _bn(out, sd, f"{s}.norm1", f"{d}.norm1")
                _bn(out, sd, f"{s}.norm2", f"{d}.norm2")
            if f"{s}.downsample.0.weight" in sd:
                _conv(out, sd, f"{s}.downsample.0", f"{d}.downsample")
                if norm == "batch":
                    _bn(out, sd, f"{s}.downsample.1", f"{d}.norm3")


def _permute_corr_window(weight: Tensor, radius: int = 4,
                         levels: int = 4) -> Tensor:
    """Transpose the per-level (D, D) correlation-window blocks of
    ``convc1``'s input channels, (O, levels*D*D, kh, kw): x-offset-major to
    y-offset-major."""
    d = 2 * radius + 1
    o, cin, kh, kw = weight.shape
    if cin != levels * d * d:
        raise ValueError(f"convc1 takes {cin} channels; expected "
                         f"{levels} x {d} x {d}")
    w = weight.reshape(o, levels, d, d, kh, kw).transpose(2, 3)
    return w.reshape(weight.shape).contiguous()


def _update_block(out, sd, src: str, dst: str) -> None:
    for name in ("convc1", "convc2", "convf1", "convf2", "conv"):
        _conv(out, sd, f"{src}.encoder.{name}", f"{dst}.encoder.{name}")
    key = f"{dst}.encoder.convc1.weight"
    out[key] = _permute_corr_window(out[key])
    for name in ("convz1", "convr1", "convq1", "convz2", "convr2", "convq2"):
        _conv(out, sd, f"{src}.gru.{name}", f"{dst}.gru.{name}")
    _conv(out, sd, f"{src}.flow_head.conv1", f"{dst}.flow_head.conv1")
    _conv(out, sd, f"{src}.flow_head.conv2", f"{dst}.flow_head.conv2")


def convert_raft_state_dict(sd: Dict[str, Any]) -> Dict[str, Tensor]:
    """A reference RAFT state_dict -> the port's ``models.raft.RAFT``
    state_dict (large variant)."""
    sd = strip_module_prefix(sd)
    stem = sd["fnet.conv1.weight"].shape[0]
    if stem != 64 or "update_block.gru.convz.weight" in sd:
        raise ValueError("convert_raft_state_dict: a checkpoint of RAFT's small "
                         f"variant (fnet stem of {stem} channels); the reference "
                         "converter maps the large variant only")
    out: Dict[str, Tensor] = {}
    _encoder(out, sd, "fnet", "fnet", "instance")
    _encoder(out, sd, "cnet", "cnet", "batch")
    _update_block(out, sd, "update_block", "update.update_block")
    # the mask head runs once, outside the iterations (models.raft.UpMaskHead)
    _conv(out, sd, "update_block.mask.0", "up_mask.mask_conv1")
    _conv(out, sd, "update_block.mask.2", "up_mask.mask_conv2")
    return out


def _tiny_unet(out, sd, src: str, dst: str) -> None:
    """TinyUNet; the reference wraps it in Sequential(TinyUNet, Sigmoid),
    so its keys live under ``<head>.0.``."""
    for i in range(3):
        s, d = f"{src}.encoder.enc_blocks.{i}", f"{dst}.unet.enc{i}"
        _conv(out, sd, f"{s}.conv1", f"{d}.conv1")
        _conv(out, sd, f"{s}.conv2", f"{d}.conv2")
        _bn(out, sd, f"{s}.norm", f"{d}.norm")
    for i in range(2):
        _conv(out, sd, f"{src}.decoder.upconvs.{i}", f"{dst}.unet.upconv{i}")
        s, d = f"{src}.decoder.dec_blocks.{i}", f"{dst}.unet.dec{i}"
        _conv(out, sd, f"{s}.conv1", f"{d}.conv1")
        _conv(out, sd, f"{s}.conv2", f"{d}.conv2")
        _bn(out, sd, f"{s}.norm", f"{d}.norm")
    _conv(out, sd, f"{src}.head", f"{dst}.unet.head")


def convert_posenet_state_dict(sd: Dict[str, Any]) -> Dict[str, Tensor]:
    """A full reference PoseNet state_dict -> the port's
    ``models.posenet.PoseNet`` state_dict."""
    sd = strip_module_prefix(sd)
    raft = convert_raft_state_dict({k[len("flow."):]: v for k, v in sd.items()
                                    if k.startswith("flow.")})
    out = {f"flow.{k}": v for k, v in raft.items()}
    _tiny_unet(out, sd, "weight_head_2d.0", "weight_head_2d")
    _tiny_unet(out, sd, "weight_head_3d.0", "weight_head_3d")
    out["loss_weight"] = _f32(sd["loss_weight"])
    return out


def convert_posenet_pth(path: str) -> Dict[str, Any]:
    """Read a reference ``.pth`` checkpoint ``{'state_dict', 'config'}`` and
    convert it: ``{'state_dict': port names, 'config'}``."""
    checkp = torch.load(path, map_location="cpu", weights_only=True)
    model_cfg = (checkp.get("config") or {}).get("model", {})
    if model_cfg.get("small", False):
        raise ValueError(f"{path}: a checkpoint of RAFT's small variant "
                         "(config model.small); the reference converter maps "
                         "the large variant only")
    return {"state_dict": convert_posenet_state_dict(checkp["state_dict"]),
            "config": checkp["config"]}


def convert_raft_pth(path: str) -> Dict[str, Tensor]:
    """Read ``raft-things.pth`` (a plain RAFT state_dict) into the port's
    RAFT state_dict."""
    return convert_raft_state_dict(
        torch.load(path, map_location="cpu", weights_only=True))
