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
import pytest
import torch

from robust_pose_tpu_torch.utils.convert import params_from_jax, train_state_from_jax


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


# --- training-step parity helpers -------------------------------------------

@pytest.fixture(scope="module")
def two_torch_threads():
    """Two intra-op threads for the module's tests, restored after: the
    training tests run many small CPU ops, and with one thread per core in
    each of several test workers those ops oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TRAIN_H, TRAIN_W, TRAIN_B = 64, 96, 2


def train_config(**train):
    """Small training config: 64x96, 2 GRU iterations, 1 UNet level, f32,
    weights on; ``lbgfs_iters`` 50 so that the LM solutions pass the IFT
    optimality check (max |dE/deps| <= 1e-3) and gradients are live."""
    return {"model": {"iters": 2, "lbgfs_iters": 50, "use_weights": True,
                      "mixed_precision": False, "unet_levels": 1,
                      "dropout": 0.0, "small": False},
            "image_shape": [TRAIN_H, TRAIN_W], "depth_scale": 250,
            "train": {"batch_size": TRAIN_B, "learning_rate": 1e-4,
                      "weight_decay": 5e-5, "epsilon": 1e-8, "grad_clip": 1.0,
                      **train}}


def train_weights(seed=21):
    """numpy-seeded port weights with the flow head damped (x0.1) and
    biased to ~-1.6 px flows: valid stereo depth (0.6 at baseline 1) and
    RAFT gradients that also pass through the flow deltas."""
    from robust_pose_tpu_torch.models.posenet import PoseNet

    cfg = dict(train_config()["model"], image_shape=(TRAIN_H, TRAIN_W))
    sd = random_state_dict(PoseNet(cfg, device="cpu"), seed)
    head = "flow.update.update_block.flow_head.conv2."
    sd[head + "weight"] = 0.1 * sd[head + "weight"]
    sd[head + "bias"] = torch.tensor([-0.1, 0.0])
    return sd


def train_batch(seed, b=TRAIN_B):
    """NCHW batch (img1, img2, img1r, img2r, mask1, mask2, gt_pose, K, bl):
    random images, all-true masks, a small known ground-truth motion."""
    rng = np.random.default_rng(seed)
    h, w = TRAIN_H, TRAIN_W
    img = lambda: rng.uniform(0, 255, (b, 3, h, w)).astype(np.float32)
    mask = np.ones((b, 1, h, w), bool)
    gt = np.zeros((b, 7), np.float32)
    gt[:, 6] = 1.0
    gt[:, 0] = 0.01
    K = np.tile(np.array([[100.0, 0, w / 2], [0, 100.0, h / 2], [0, 0, 1.0]],
                         np.float32)[None], (b, 1, 1))
    return (img(), img(), img(), img(), mask, mask, gt, K,
            np.ones((b,), np.float32))


def jax_trainer(config, sd):
    """The JAX PoseNetTrainer on one CPU device, its state made from the
    port weights ``sd``, replicated as the train step's outputs are (so a
    second step reuses the first step's compile)."""
    from robust_pose_tpu.parallel.mesh import make_mesh, replicate
    from robust_pose_tpu.train.trainer import PoseNetTrainer as JTrainer

    mesh = make_mesh(1)
    tr = JTrainer(config, mesh=mesh)
    state = tr.init_state(jax.random.PRNGKey(0), variables=jax_variables(sd))
    return tr, replicate(mesh, state), mesh


def port_trainer(config, sd):
    """The port's trainer on the CPU from ``sd``, recording the gradients
    its optimizer receives."""
    from robust_pose_tpu_torch.train.trainer import PoseNetTrainer

    tr = PoseNetTrainer(config, device="cpu")
    state = tr.init_state(sd)
    tr.seen_grads = []
    update = tr.optimizer.update

    def spy(params, grads, opt_state):
        tr.seen_grads.append({k: None if g is None else g.clone()
                              for k, g in grads.items()})
        return update(params, grads, opt_state)

    tr.optimizer.update = spy
    return tr, state


def jax_grads_from_first_step(state1, metrics, max_norm):
    """The raw gradients of a JAX train step taken from zero Adam moments:
    mu = (1 - b1) * clip(g), and the clip scale follows from the step's
    grad_norm. Port names and layouts."""
    gnorm = float(metrics["train/grad_norm"])
    scale = gnorm / max_norm if gnorm >= max_norm else 1.0
    mu = train_state_from_jax(state1)["mu"]
    return {k: v / np.float32(0.1) * scale for k, v in mu.items()}


def assert_step_matches(r, grad_rtol, lr=1e-4):
    """Loss rtol 1e-4; every gradient within ``grad_rtol`` of the leaf's
    largest JAX gradient (plus 2e-5 of the largest of all, for leaves whose
    gradient is rounding noise, such as a bias that a batch norm cancels);
    the parameter updates within 1e-3 of the learning rate where a
    gradient is above twice its tolerance (elsewhere the sign of Adam's
    first step, ~lr * sign(g), is decided by rounding), and within the step
    bound 2 lr everywhere; the BatchNorm statistics rtol 1e-4."""
    for k in ("loss_total", "loss_rot", "loss_trans"):
        np.testing.assert_allclose(float(r["pm"]["train/" + k]),
                                   float(r["jm"]["train/" + k]), rtol=1e-4)
    np.testing.assert_allclose(float(r["pm"]["train/grad_norm"]),
                               float(r["jm"]["train/grad_norm"]), rtol=2e-3)
    new_j = params_from_jax({"params": r["jst1"].params,
                             "batch_stats": r["jst1"].batch_stats})
    floor = 2e-5 * max(float(g.abs().max()) for g in r["jgrads"].values())
    for k, gj in r["jgrads"].items():
        gp = r["pgrads"][k]
        gj = gj.numpy()
        gp = np.zeros_like(gj) if gp is None else gp.numpy()
        atol = grad_rtol * np.abs(gj).max() + floor
        np.testing.assert_allclose(gp, gj, rtol=0, atol=atol, err_msg=k)
        dj = new_j[k].numpy() - r["sd"][k].numpy()
        dp = r["pst"].params[k].detach().numpy() - r["sd"][k].numpy()
        big = np.abs(gj) > 2 * atol
        np.testing.assert_allclose(dp[big], dj[big], rtol=0, atol=1e-3 * lr,
                                   err_msg=k)
        assert np.abs(dp - dj).max() <= 2 * lr, k
    for k, v in r["pst"].batch_stats.items():
        np.testing.assert_allclose(v.numpy(), new_j[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
