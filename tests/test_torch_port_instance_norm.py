"""The port's instance norm (``ops/instance_norm``: the norm with its ReLU
as one kernel call on the card, its plain version here) against the JAX
package on the CPU, on the same numpy inputs: forward in f32 and bf16,
the gradient against ``jax.vjp`` through the Pallas statistics in
interpret mode, the RAFT encoders with the ReLU fused against the unfused
composition, and the work the wrapper registers with ``utils.costs``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from robust_pose_tpu.ops import pallas_instance_norm as pin
from robust_pose_tpu_torch.models import raft
from robust_pose_tpu_torch.ops import instance_norm as K2
from robust_pose_tpu_torch.utils import costs

WIDTHS = (32, 64, 96, 128)    # RAFT small's and RAFT large's fnet widths


def _input(c, seed, shape=(2, 6, 10)):
    rng = np.random.default_rng(seed)
    return rng.normal(0.4, 1.7, size=(*shape, c)).astype(np.float32)


def _jax_norm(x, relu):
    y = pin.instance_norm(x)
    return jax.nn.relu(y) if relu else y


def bf16_ulp(v):
    """One bf16 ulp of |v| (8 significant bits), |v| taken at least 2^-12:
    below that the f32 rounding of the statistics (~1e-7 of |mu| rstd),
    not the bf16 cast, separates two correct results."""
    a = np.maximum(np.abs(v), 2.0 ** -12)
    return np.exp2(np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("c", WIDTHS)
def test_norm_matches_jax_f32(c, relu):
    """f32: ``instance_norm`` (the autograd Function, plain on the CPU) and
    ``instance_norm_plain`` against the JAX norm (then ``jax.nn.relu``),
    rtol / atol 1e-5 on unit-variance outputs."""
    x = _input(c, seed=c)
    ref = np.asarray(_jax_norm(jnp.asarray(x), relu))
    for got in (K2.instance_norm(torch.from_numpy(x), relu=relu),
                K2.instance_norm_plain(torch.from_numpy(x), relu=relu)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    if relu:
        assert (ref == 0).any() and (ref >= 0).all()


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("c", WIDTHS)
def test_norm_matches_jax_bf16(c, relu):
    """bf16 in and out: within one bf16 ulp of the JAX norm (the two
    packages sum the statistics in other orders, so a value on a rounding
    boundary may round the other way)."""
    x = _input(c, seed=100 + c)
    ref = np.asarray(_jax_norm(jnp.asarray(x).astype(jnp.bfloat16), relu)
                     .astype(jnp.float32))
    got = K2.instance_norm(torch.from_numpy(x).bfloat16(), relu=relu)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - ref)
    assert (err <= bf16_ulp(ref)).all(), float(err.max())


def test_norm_fwd_moments_match_f64():
    """``instance_norm_fwd`` on the CPU: y equal to ``instance_norm``'s, mu
    and rstd within 1e-5 of an f64 reference."""
    x = _input(96, seed=3, shape=(3, 5, 7))
    y, mu, rstd = K2.instance_norm_fwd(torch.from_numpy(x), relu=True)
    assert torch.equal(y, K2.instance_norm(torch.from_numpy(x), relu=True))
    x64 = x.astype(np.float64)
    m = x64.mean(axis=(1, 2))
    var = np.maximum((x64 * x64).mean(axis=(1, 2)) - m * m, 0.0)
    np.testing.assert_allclose(mu.numpy(), m, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), 1.0 / np.sqrt(var + K2.EPS), rtol=1e-5)


def test_wide_channels_take_plain_means():
    """C > 128 (no kernel): plain means on every device, then the ReLU."""
    x = _input(160, seed=5)
    ref = np.asarray(_jax_norm(jnp.asarray(x), True))
    got = K2.instance_norm(torch.from_numpy(x), relu=True)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


class _TpuBackend:
    """``jax`` as the JAX norm sees it on a TPU: its statistics branch."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("c", [32, 128])
def test_gradient_matches_jax_vjp(c, relu, monkeypatch):
    """The gradient through ``_InstanceNorm`` (its backward recomputes the
    plain composition with the statistics through ``instance_norm_stats``)
    against ``jax.vjp`` of the JAX norm on its TPU branch, the Pallas
    statistics in interpret mode with their custom VJP; rtol 1e-4. The
    port's statistics come back without autograd history, as the kernel's
    do on the card, so the gradient must come from their own backward."""
    plain = K2.instance_norm_stats_plain
    monkeypatch.setattr(K2, "instance_norm_stats_plain",
                        lambda x: tuple(t.detach() for t in plain(x)))
    j_stats = pin.instance_norm_stats
    monkeypatch.setattr(pin, "jax", _TpuBackend())
    monkeypatch.setattr(pin, "instance_norm_stats", lambda a: j_stats(a, True))
    rng = np.random.default_rng(c + relu)
    x = rng.normal(0.3, 1.5, size=(2, 8, 12, c)).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)
    y_ref, vjp = jax.vjp(lambda a: _jax_norm(a, relu), jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(ct))
    ref = np.asarray(ref)
    xt = torch.from_numpy(x).requires_grad_()
    y = K2.instance_norm(xt, relu=relu)
    assert y.grad_fn is not None and "_InstanceNorm" in type(y.grad_fn).__name__
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), rtol=1e-5,
                               atol=1e-5)
    y.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(xt.grad.numpy(), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def test_inference_saves_nothing():
    """Without a gradient to take, the norm records no graph and keeps no
    input alive; with one, its node holds x."""
    x = torch.from_numpy(_input(64, seed=9))
    assert K2.instance_norm(x, relu=True).grad_fn is None
    xg = x.clone().requires_grad_()
    node = K2.instance_norm(xg, relu=True).grad_fn
    assert len(node.saved_tensors) == 1 and node.saved_tensors[0] is not None


def _unfused(monkeypatch):
    """The encoders' composition before the fusion: the norm, then a
    separate ``F.relu``."""
    norm = raft.instance_norm_nchw
    monkeypatch.setattr(raft, "instance_norm_nchw",
                        lambda x, relu=False: F.relu(norm(x)) if relu else norm(x))


def _bits(t):
    return t.detach().contiguous().view(torch.int16 if t.dtype == torch.bfloat16
                                        else torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("small", [False, True])
def test_encoders_fused_relu_equal_unfused_bitwise(small, dtype, monkeypatch):
    """``BasicEncoder`` / ``SmallEncoder`` with the ReLU inside the norm give
    the unfused composition's outputs bit for bit on the CPU, and in f32
    the same weight gradients bit for bit."""
    cls = raft.SmallEncoder if small else raft.BasicEncoder
    torch.manual_seed(1)
    enc = cls(output_dim=48, norm="instance", dtype=dtype)
    g = torch.Generator().manual_seed(2)
    img = (2.0 * torch.rand(2, 3, 32, 48, generator=g) - 1.0).contiguous(
        memory_format=torch.channels_last)

    def run():
        enc.zero_grad()
        out = enc(img)
        grads = None
        if dtype == torch.float32:
            out.float().square().sum().backward()
            grads = [p.grad.clone() for p in enc.parameters()]
        return out, grads

    fused, g_fused = run()
    _unfused(monkeypatch)
    plain, g_plain = run()
    assert fused.dtype == plain.dtype and torch.equal(_bits(fused), _bits(plain))
    if g_fused is not None:
        assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(g_fused, g_plain))


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_costs_count_what_the_wrapper_registers(dtype, relu):
    """``instance_norm`` registers ``costs.instance_norm(x)`` under
    "instance_norm" and nothing else (its plain ops run uncounted); the
    statistics entry keeps its own formula."""
    x = torch.from_numpy(_input(96, seed=11)).to(dtype)
    flops, nbytes, dt = costs.instance_norm(x)
    with costs.count() as c:
        K2.instance_norm(x, relu=relu)
    assert dict(c.by_op) == {"instance_norm": [flops, nbytes, 1]}
    assert dict(c.by_dtype) == {dt: [flops, nbytes]}
    b, h, w, ch = x.shape
    n = x.numel()
    assert (flops, nbytes) == (5 * n, 3 * n * x.element_size() + 2 * b * ch * 4)
    floor = costs.instance_norm(x, x_reads=1)[1]
    assert nbytes - floor == n * x.element_size()


@pytest.mark.parametrize("b,h,w", [(1, 256, 320), (16, 256, 320), (16, 64, 80),
                                   (1, 64, 80), (3, 5, 7), (2000, 1, 1)])
def test_split_covers_every_row_once(b, h, w, monkeypatch):
    """The host's cut of each sample's rows into the kernels' blocks (132
    SMs): every chunk non-empty, together exactly H*W rows, as the C
    entries check; enough blocks to fill the card where the rows allow;
    no sample and more samples than a grid dimension holds refused."""
    monkeypatch.setitem(K2._n_sm, None, 132)
    rows_per, nsplit = K2._grid(torch.empty(b, h, w, 8), "test")
    hw = h * w
    assert rows_per >= 1 and (nsplit - 1) * rows_per < hw <= nsplit * rows_per
    assert b * nsplit >= 0.9 * min(8 * 132, b * -(-hw // 64))
    for bad in ((0, h, w), (65536, 1, 1)):
        with pytest.raises(ValueError):
            K2._grid(torch.empty(*bad, 8), "test")
