"""The port's RAFT and TinyUNet against the JAX package on the CPU, f32,
with the same numpy-seeded weights (through ``params_from_jax``'s inverse)
and inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_pose_tpu.models.raft import RAFT as JRAFT
from robust_pose_tpu.models.unet import TinyUNet as JTinyUNet
from robust_pose_tpu_torch.models.raft import RAFT
from robust_pose_tpu_torch.models.unet import TinyUNet
from tests.test_torch_port_common import jax_variables, random_state_dict

H, W = 64, 96


@pytest.fixture(scope="module")
def rafts():
    port = RAFT(iters=2, dtype=torch.float32, corr_dtype=torch.float32).eval()
    sd = random_state_dict(port, seed=3)
    port.load_state_dict(sd)
    jmodel = JRAFT(iters=2, dtype=jnp.float32, corr_dtype=jnp.float32)
    return port, jmodel, jax_variables(sd)


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 255, (n, H, W, 3)).astype(np.float32)


@pytest.mark.parametrize("method", ["encode_fnet", "encode_cnet"])
def test_raft_encoders_match_jax(rafts, method):
    """f32 atol 1e-4 on O(1) features after 17 conv layers."""
    port, jmodel, v = rafts
    img = _images(2, 0)
    with jax.default_matmul_precision("float32"):
        ref = jmodel.apply(v, jnp.asarray(img), method=getattr(JRAFT, method))
    with torch.no_grad():
        got = getattr(port, method)(torch.from_numpy(img))
    if method == "encode_fnet":
        ref, got = (ref,), (got,)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)


def test_raft_flow_from_features_matches_jax(rafts):
    """iters = 2; both sides leave ``lookup`` at "auto" and so look up a
    materialized pyramid (the "xla" route, what "auto" takes on the CPU in
    both packages). Flow atol 1e-3 px, hidden state and context atol
    1e-4."""
    port, jmodel, v = rafts
    rng = np.random.default_rng(1)
    f1, f2 = (rng.normal(size=(2, H // 8, W // 8, 256)).astype(np.float32)
              for _ in range(2))
    net = np.tanh(rng.normal(size=(2, H // 8, W // 8, 128))).astype(np.float32)
    inp = np.maximum(rng.normal(size=(2, H // 8, W // 8, 128)), 0).astype(np.float32)
    args = [f1, f2, net, inp]
    with jax.default_matmul_precision("float32"):
        ref = jmodel.apply(v, *map(jnp.asarray, args),
                           method=JRAFT.flow_from_features)
    with torch.no_grad():
        got = port.flow_from_features(*map(torch.from_numpy, args))
    assert got[0].shape == (2, H, W, 2)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-3)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)


@pytest.mark.parametrize("levels,in_hw,out_hw", [(1, (8, 12), (64, 96)),
                                                 (3, (48, 64), (384, 512))])
def test_tiny_unet_matches_jax(levels, in_hw, out_hw):
    """VALID convs, centre crops, BatchNorm on randomized running stats and
    the final bilinear resize (jax.image.resize 'linear' vs
    F.interpolate(bilinear, align_corners=False)); f32 atol 1e-5."""
    cin = 24
    port = TinyUNet(cin, out_hw, torch.float32, levels).eval()
    sd = random_state_dict(port, seed=levels)
    port.load_state_dict(sd)
    x = np.random.default_rng(levels).normal(size=(2, *in_hw, cin)).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        ref = JTinyUNet(cin, out_hw, jnp.float32, levels).apply(
            jax_variables(sd), jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (2, *out_hw, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
