"""Shared helpers of the port's parity tests (robust_pose_tpu_torch against
the JAX package on the CPU), and the weight-conversion tests.

Random weights are made with numpy for the port's state_dict names and
shapes, handed to the port directly and to the JAX package through the
inverse of ``params_from_jax``; that both packages then accept them and
compute the same thing is what the parity tests check.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from robust_pose_tpu_torch.utils.convert import params_from_jax


def random_state_dict(model: torch.nn.Module, seed: int, bias_scale=0.1):
    """numpy-seeded weights for every entry of ``model.state_dict()``:
    LeCun-normal conv kernels, small random biases, randomized BatchNorm
    affine parameters and running statistics (as tests/test_e2e_torch_parity
    does), unit loss weights."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k == "loss_weight":
            a = np.ones(shape)
        elif k.endswith("running_mean"):
            a = rng.normal(0.0, 0.2, shape)
        elif k.endswith("running_var"):
            a = rng.uniform(0.8, 1.5, shape)
        elif k.endswith("weight") and len(shape) == 1:      # BatchNorm scale
            a = rng.uniform(0.8, 1.2, shape)
        elif k.endswith("weight"):
            fan_in = np.prod(shape[1:]) if ".upconv" not in k else \
                shape[0] * shape[2] * shape[3]
            a = rng.normal(0.0, 1.0, shape) / np.sqrt(fan_in)
        else:
            a = rng.normal(0.0, bias_scale, shape)
        out[k] = torch.from_numpy(a.astype(np.float32))
    return out


def jax_variables(state_dict):
    """Inverse of ``params_from_jax``: port state_dict -> flax tree."""
    params, stats = {}, {}

    def put(tree, path, value):
        for p in path[:-1]:
            tree = tree.setdefault(p, {})
        tree[path[-1]] = jnp.asarray(value)

    for k, v in state_dict.items():
        a = v.numpy()
        *mods, leaf = k.split(".")
        if not mods:
            put(params, [leaf], a)
        elif leaf == "running_mean":
            put(stats, mods + ["mean"], a)
        elif leaf == "running_var":
            put(stats, mods + ["var"], a)
        elif leaf == "weight" and a.ndim == 1:
            put(params, mods + ["scale"], a)
        elif leaf == "weight":
            put(params, mods + ["kernel"], a.transpose(2, 3, 1, 0))
        else:
            put(params, mods + [leaf], a)
    return {"params": params, "batch_stats": stats}


def test_params_from_jax_matches_flax_tree():
    """Every parameter of the JAX PoseNet maps onto a port parameter of the
    same size, and nothing of the port is left unmapped."""
    from robust_pose_tpu.models.posenet import PoseNet as JPoseNet
    from robust_pose_tpu_torch.models.posenet import PoseNet

    h, w = 64, 96
    cfg = {"image_shape": (h, w), "iters": 1, "unet_levels": 1}
    img = jnp.zeros((1, h, w, 3))
    K = jnp.eye(3)[None]
    shapes = jax.eval_shape(
        lambda: JPoseNet(cfg).init(jax.random.PRNGKey(0), img, img, K,
                                   jnp.ones((1,)), img, img))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = params_from_jax(tree)
    port = PoseNet(cfg, device="cpu").state_dict()
    assert set(sd) == set(port)
    for k in port:
        assert tuple(sd[k].shape) == tuple(port[k].shape), k


def test_params_from_jax_layouts():
    """Conv and ConvTranspose kernels and BatchNorm entries land in the
    torch layouts (values, not only shapes)."""
    rng = np.random.default_rng(0)
    conv = rng.normal(size=(3, 5, 4, 6)).astype(np.float32)    # kh kw I O
    convt = rng.normal(size=(2, 2, 6, 4)).astype(np.float32)   # kh kw O I
    tree = {"params": {"a": {"conv1": {"kernel": conv, "bias": np.ones(6)},
                             "upconv0": {"kernel": convt},
                             "norm": {"scale": np.full(6, 2.0),
                                      "bias": np.zeros(6)}},
                       "loss_weight": np.array([1.0, 2.0])},
            "batch_stats": {"a": {"norm": {"mean": np.full(6, 3.0),
                                           "var": np.full(6, 4.0)}}}}
    sd = params_from_jax(tree)
    np.testing.assert_array_equal(sd["a.conv1.weight"].numpy(),
                                  conv.transpose(3, 2, 0, 1))
    tconv = torch.nn.ConvTranspose2d(4, 6, 2, stride=2, bias=False)
    assert tuple(sd["a.upconv0.weight"].shape) == tuple(tconv.weight.shape)
    np.testing.assert_array_equal(sd["a.upconv0.weight"].numpy()[1, 2],
                                  convt[:, :, 2, 1])
    assert float(sd["a.norm.weight"][0]) == 2.0
    assert float(sd["a.norm.running_mean"][0]) == 3.0
    assert float(sd["a.norm.running_var"][0]) == 4.0
    np.testing.assert_array_equal(sd["loss_weight"].numpy(), [1.0, 2.0])
