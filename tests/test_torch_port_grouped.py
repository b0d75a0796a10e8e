"""RAFT's ``lookup: grouped`` in the port against the JAX package on the
CPU: the plain version of K6/K7 against both Pallas lookups in interpret
mode, the port's RAFT against the JAX RAFT with the grouped lookup, and
the lookup's refusal of a gradient."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import robust_pose_tpu.ops.pallas_lookup as j_pallas_lookup
from robust_pose_tpu.models.raft import RAFT as JRAFT
from robust_pose_tpu.models.raft import build_corr_pyramid as j_build_corr_pyramid
from robust_pose_tpu_torch.models.posenet import PoseNet
from robust_pose_tpu_torch.models.raft import RAFT
from robust_pose_tpu_torch.ops import corr_pixel
from tests.test_torch_port_common import jax_variables, random_state_dict

B, H8, W8 = 1, 16, 20       # M = 320 queries, not a multiple of 128


def _volumes(dtype, seed=0):
    """A 4-level (B, N, Hl, Wl) pyramid of random C = 16 features, as
    numpy arrays (exactly representable in ``dtype``)."""
    rng = np.random.default_rng(seed)
    f1, f2 = (jnp.asarray(rng.normal(size=(B, H8, W8, 16)), jnp.float32)
              for _ in range(2))
    pyr = j_build_corr_pyramid(f1, f2, dtype=dtype)
    return [np.array(v, np.float32) for v in pyr]


def _centres(case):
    yg, xg = np.meshgrid(np.arange(H8, dtype=np.float32),
                         np.arange(W8, dtype=np.float32), indexing="ij")
    base = np.tile(np.stack([xg, yg], -1)[None], (B, 1, 1, 1))
    if case == "in_range":
        rng = np.random.default_rng(1)
        return (base + rng.uniform(-3.0, 3.0, base.shape)).astype(np.float32)
    return (base * 3.0 - 50.0).astype(np.float32)   # far outside, partly back in


@pytest.mark.parametrize("kernel", ["K6", "K7"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["in_range", "far"])
def test_plain_lookup_matches_pallas(kernel, dtype, case):
    """The port's pyramid and level wrappers (the plain version on the CPU)
    against ``pallas_lookup_pyramid`` (K6) / ``_grouped`` (K7) in interpret
    mode, every level: atol 1e-5 + rtol 1e-5 (the same f32 products; the
    Pallas sums run as dot products over the whole level, whose zero terms
    are exact but whose two live terms may be fused into one rounding)."""
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    vols = _volumes(jdt)
    coords = _centres(case)
    j_fn = (j_pallas_lookup.pallas_lookup_pyramid if kernel == "K6"
            else j_pallas_lookup.pallas_lookup_pyramid_grouped)
    ref = j_fn([jnp.asarray(v, jdt) for v in vols], jnp.asarray(coords),
               interpret=True)
    pyr = [torch.from_numpy(v).to(tdt) for v in vols]
    p_pyr = (corr_pixel.pixel_lookup_pyramid if kernel == "K6"
             else corr_pixel.grouped_lookup_pyramid)
    got = p_pyr(pyr, torch.from_numpy(coords))
    n = H8 * W8
    for lvl, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == (B, 81, n) and g.dtype == torch.float32
        r = np.asarray(r).reshape(B, n, 81).transpose(0, 2, 1)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-5,
                                   err_msg=f"level {lvl}")
    # the level wrapper: the JAX contract (M, 81), centres in level pixels
    p_lvl = (corr_pixel.pixel_lookup_level if kernel == "K6"
             else corr_pixel.grouped_lookup_level)
    lvl1 = p_lvl(pyr[1].reshape(B * n, *pyr[1].shape[2:]),
                 torch.from_numpy(coords.reshape(B * n, 2) / 2.0))
    np.testing.assert_allclose(
        lvl1.numpy(), np.asarray(ref[1]).reshape(B * n, 81), rtol=1e-5, atol=1e-5)
    if case == "far":    # windows wholly off the level, and partly on it
        assert bool((got[0] == 0).all(dim=1).any())
        assert any(bool((g != 0).any()) for g in got[1:])


def test_raft_grouped_matches_jax(monkeypatch):
    """The port's RAFT with ``lookup="grouped"`` against the JAX RAFT with
    the same lookup (its Pallas kernel run in interpret mode), f32, 64x96,
    2 GRU iterations: flow atol 1e-3 px, hidden state and context atol 1e-4."""
    monkeypatch.setattr(j_pallas_lookup, "pallas_lookup_pyramid_grouped",
                        functools.partial(
                            j_pallas_lookup.pallas_lookup_pyramid_grouped,
                            interpret=True))
    port = RAFT(iters=2, dtype=torch.float32, corr_dtype=torch.float32,
                lookup="grouped").eval()
    sd = random_state_dict(port, seed=3)
    port.load_state_dict(sd)
    jmodel = JRAFT(iters=2, dtype=jnp.float32, corr_dtype=jnp.float32,
                   lookup="grouped")
    rng = np.random.default_rng(2)
    f1, f2 = (rng.normal(size=(1, 8, 12, 256)).astype(np.float32) for _ in range(2))
    net = np.tanh(rng.normal(size=(1, 8, 12, 128))).astype(np.float32)
    inp = np.maximum(rng.normal(size=(1, 8, 12, 128)), 0).astype(np.float32)
    args = [f1, f2, net, inp]
    with jax.default_matmul_precision("float32"):
        ref = jmodel.apply(jax_variables(sd), *map(jnp.asarray, args),
                           method=JRAFT.flow_from_features)
    with torch.no_grad():
        got = port.flow_from_features(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-3)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)


def test_grouped_lookup_refuses_a_gradient():
    """Asked for a gradient, the grouped lookup raises and names the
    lane-wise lookup; without grad mode, or with ``stop_flow_grad``, a
    training forward and backward through PoseNet run."""
    vol = [torch.zeros(1, 6, 2, 3, requires_grad=True)]
    coords = torch.zeros(1, 2, 3, 2)
    with pytest.raises(RuntimeError, match="lanewise"):
        corr_pixel.grouped_lookup_pyramid(vol, coords)
    with torch.no_grad():
        corr_pixel.grouped_lookup_pyramid(vol, coords)

    h, w = 64, 96
    cfg = {"image_shape": (h, w), "iters": 1, "lbgfs_iters": 3,
           "use_weights": True, "mixed_precision": False, "unet_levels": 1,
           "lookup": "grouped"}
    rng = np.random.default_rng(0)
    img = lambda: torch.from_numpy(rng.uniform(0, 255, (1, h, w, 3)).astype(np.float32))
    K = torch.tensor([[[100.0, 0, w / 2], [0, 100.0, h / 2], [0, 0, 1.0]]])
    args = (img(), img(), K, torch.ones(1), img(), img())
    for stop, raises in ((False, True), (True, False)):
        model = PoseNet(dict(cfg, stop_flow_grad=stop), device="cpu")
        model.load_state_dict(random_state_dict(model, seed=4))
        if raises:
            with pytest.raises(RuntimeError, match="lanewise"):
                model(*args)
            continue
        out = model(*args, train=True)
        out.conf1.sum().backward()
        grads = [p.grad for n, p in model.named_parameters()
                 if n.startswith("weight_head_2d.")]
        assert all(g is not None for g in grads)
        assert all(p.grad is None for n, p in model.named_parameters()
                   if n.startswith("flow."))
