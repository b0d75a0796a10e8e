"""The constants ``se3.quat_conj`` and ``ops.warp.warp_then_eighth`` use
are made on the tensors' own device (fills and ``arange``), so that on the
card they copy nothing from the host and never wait for the stream. Each
result is held bit for bit to the host-constant form they replaced
(``new_tensor`` of a Python list), in every float dtype, over inputs with
signed zeros, infinities and NaNs: the integer views of the bits must be
equal, not close.

This file imports no JAX; on the card: ``python -m pytest --noconftest
-p no:cacheprovider tests/test_torch_port_constants.py -m card``.
"""
import pytest
import torch

from robust_pose_tpu_torch import se3
from robust_pose_tpu_torch.ops import warp

DTYPES = (torch.float32, torch.float16, torch.bfloat16, torch.float64)
DEVICES = ("cpu", pytest.param("cuda", marks=pytest.mark.card))
SPECIAL = (0.0, -0.0, float("inf"), float("-inf"), float("nan"), 1.0, -1.0)
BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with python -m pytest "
                    "--noconftest tests/test_torch_port_constants.py -m card")
    return torch.device(name)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(BITS[x.element_size()]).cpu()


def _with_specials(shape, dtype, device, seed, scale=1.0) -> torch.Tensor:
    """Normal draws times ``scale`` with every special value scattered over
    them."""
    g = torch.Generator().manual_seed(seed)
    x = scale * torch.randn(shape, generator=g, dtype=torch.float64).flatten()
    at = torch.randperm(x.numel(), generator=g)[:4 * len(SPECIAL)]
    x[at] = torch.tensor(SPECIAL, dtype=torch.float64).repeat(4)
    return x.reshape(shape).to(dtype=dtype, device=device)


def _quat_conj_host(q):
    return q * q.new_tensor([-1.0, -1.0, -1.0, 1.0])


def _warp_then_eighth_host(x, flow):
    b, h, w, c = x.shape
    h8, w8 = h // 8, w // 8
    ft = flow.reshape(b, h8, 8, w8, 8, 2)[:, :, 3:5, :, 3:5]
    taps = flow.new_tensor([3.0, 4.0])
    rows = 8.0 * torch.arange(h8, dtype=flow.dtype, device=flow.device)[:, None] + taps
    cols = 8.0 * torch.arange(w8, dtype=flow.dtype, device=flow.device)[:, None] + taps
    cy = rows[None, :, :, None, None] + ft[..., 1]
    cx = cols[None, None, None, :, :] + ft[..., 0]
    out = warp.grid_sample(x, cx.reshape(b, -1), cy.reshape(b, -1))
    return out.reshape(b, h8, 2, w8, 2, c).mean(dim=(2, 4))


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_quat_conj_and_inv_match_the_host_constant_bit_for_bit(dtype, device):
    dev = _device(device)
    q = _with_specials((16, 4), dtype, dev, seed=1)
    new = se3.quat_conj(q)
    assert new.dtype == dtype and new.device == q.device
    assert torch.equal(_bits(new), _bits(_quat_conj_host(q)))
    g = _with_specials((5, 3, 7), dtype, dev, seed=2)
    new = se3.inv(g)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(se3, "quat_conj", _quat_conj_host)
        old = se3.inv(g)
    assert torch.equal(_bits(new), _bits(old))


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_warp_then_eighth_matches_the_host_taps_bit_for_bit(dtype, device):
    dev = _device(device)
    x = _with_specials((2, 16, 24, 3), dtype, dev, seed=3)
    flow = _with_specials((2, 16, 24, 2), dtype, dev, seed=4, scale=6.0)
    new = warp.warp_then_eighth(x, flow)
    assert new.shape == (2, 2, 3, 3) and new.dtype == dtype
    assert torch.equal(_bits(new), _bits(_warp_then_eighth_host(x, flow)))
    # the taps themselves, in every float dtype
    taps = torch.arange(3, 5, dtype=dtype, device=dev)
    assert torch.equal(_bits(taps), _bits(flow.new_tensor([3.0, 4.0])))
