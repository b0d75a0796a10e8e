"""The training pieces of the port's later slice on the CPU: the encoders'
channel dropout (and its masks under remat), ``remat_policy: "dots"``,
and the generic declarative layer against the JAX package's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_pose_tpu.models.raft import RAFT as JRAFT
from robust_pose_tpu.solver.declarative import (
    make_declarative_layer as j_make_declarative_layer,
)
from robust_pose_tpu_torch.models import raft as raft_mod
from robust_pose_tpu_torch.models.raft import RAFT
from robust_pose_tpu_torch.solver.declarative import make_declarative_layer
from tests.test_torch_port_common import (  # noqa: F401 (fixture)
    jax_variables,
    random_state_dict,
    two_torch_threads,
)

H, W = 64, 96
P = 0.3


def _raft(**kw):
    m = RAFT(iters=1, dtype=torch.float32, corr_dtype=torch.float32, small=True,
             **kw)
    m.load_state_dict(random_state_dict(m, seed=4))
    return m


def _images(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 255, (n, H, W, 3)).astype(np.float32)


def _keep_share(out, ref):
    """Per (sample, channel): all zeros (dropped) or ref / (1 - P) (kept);
    returns the kept share, asserting the scale within 1e-6 relative."""
    out, ref = out.reshape(out.shape[0], -1, out.shape[-1]), ref.reshape(
        ref.shape[0], -1, ref.shape[-1])
    dropped = np.all(out == 0.0, axis=1)
    kept = ~dropped
    scaled = ref / (1.0 - P)
    np.testing.assert_allclose(np.where(kept[:, None], out, scaled), scaled,
                               rtol=1e-6, atol=1e-6)
    return kept.mean(), kept.size


def test_dropout_masks_channels_like_jax():
    """fnet and cnet with dropout 0.3 in training: each (sample, channel) of
    the output is either all zero or the eval output scaled by 1 / (1 - p),
    in the port and in the JAX package; the kept share of each lies within
    4 binomial standard deviations of 1 - p (the bits differ: the port
    draws from a torch.Generator, JAX from its key). With ``train=False``
    the port's encoders are the identity of their eval pass."""
    port = _raft(dropout=P)
    img = torch.from_numpy(_images())
    g = torch.Generator().manual_seed(5)
    jm = JRAFT(iters=1, dtype=jnp.float32, corr_dtype=jnp.float32, small=True,
               dropout=P)
    v = jax_variables(port.state_dict())
    with torch.no_grad():
        assert torch.equal(port.encode_fnet(img, False, g), port.encode_fnet(img))
        for a, b in zip(port.encode_cnet(img, False, g), port.encode_cnet(img)):
            assert torch.equal(a, b)
        x = port._prep(img)
        for net in (port.fnet, port.cnet):
            # the raw encoder output: cnet's tanh/relu split hides the zeros
            keep = raft_mod.dropout_keep(img.shape[0], net.conv2.out_channels,
                                         P, g)
            share, n = _keep_share(net(x, keep).permute(0, 2, 3, 1).numpy(),
                                   net(x).permute(0, 2, 3, 1).numpy())
            assert abs(share - (1 - P)) <= 4 * np.sqrt(P * (1 - P) / n)
    with jax.default_matmul_precision("float32"):
        jref = jm.apply(v, jnp.asarray(_images()), method=JRAFT.encode_fnet)
        jout = jm.apply(v, jnp.asarray(_images()), True, method=JRAFT.encode_fnet,
                        rngs={"dropout": jax.random.PRNGKey(0)})
    share, n = _keep_share(np.asarray(jout), np.asarray(jref))
    assert abs(share - (1 - P)) <= 4 * np.sqrt(P * (1 - P) / n)


def test_trainer_dropout_generator_follows_the_step():
    """The trainer's dropout stream is a function of the step: the same
    masks for one step (every microbatch, a resumed run), others for the
    next; none without dropout."""
    from robust_pose_tpu_torch.train.trainer import PoseNetTrainer

    cfg = {"model": {"iters": 1, "unet_levels": 1, "small": True,
                     "dropout": P, "mixed_precision": False},
           "image_shape": [H, W], "train": {}}
    tr = PoseNetTrainer(cfg, device="cpu")
    draw = lambda s: raft_mod.dropout_keep(8, 128, P, tr.dropout_generator(s))
    assert torch.equal(draw(3), draw(3))
    assert not torch.equal(draw(3), draw(4))
    cfg["model"]["dropout"] = 0.0
    assert PoseNetTrainer(cfg, device="cpu").dropout_generator(3) is None


def _grads(model, generator_seed=None):
    """Gradients of a fixed scalar of one small RAFT pass (train=True) with
    respect to every parameter and to the images."""
    img1 = torch.from_numpy(_images(2, 1)).requires_grad_()
    img2 = torch.from_numpy(_images(2, 2))
    g = (None if generator_seed is None
         else torch.Generator().manual_seed(generator_seed))
    flow, net, inp = model(img1, img2, True, g)
    w = torch.linspace(-1.0, 1.0, flow.numel()).reshape(flow.shape)
    loss = (flow * w).sum() + net.square().sum() + inp.sum()
    params = [p for _, p in sorted(model.named_parameters())]
    return torch.autograd.grad(loss, params + [img1], allow_unused=True)


def _assert_bit_equal(a, b):
    for x, y in zip(a, b):
        if x is None or y is None:
            assert x is None and y is None
        else:
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.usefixtures("two_torch_threads")
@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_dropout_under_remat_keeps_its_masks(policy):
    """Dropout 0.3 with ``remat`` on, under each policy: the masks are drawn
    outside the recomputed region, so the gradients equal the run without
    remat bit for bit (a mask drawn again inside the recomputation would
    differ: ``torch.utils.checkpoint`` restores only the default
    generators)."""
    plain = _grads(_raft(dropout=P, lookup="lanewise"), generator_seed=11)
    remat = _grads(_raft(dropout=P, lookup="lanewise", remat=True,
                         remat_policy=policy), generator_seed=11)
    _assert_bit_equal(plain, remat)


@pytest.mark.usefixtures("two_torch_threads")
def test_remat_dots_saves_products_and_keeps_gradients(monkeypatch):
    """``remat_policy: "dots"`` keeps the convolutions' and products'
    outputs (the policy is asked about and saves ``aten.convolution``) and
    its gradients equal those of ``"nothing"`` and of no remat bit for bit;
    any other policy raises by name."""
    seen = []
    policy = raft_mod._dots_policy

    def spy(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        seen.append((op, decision))
        return decision

    monkeypatch.setattr(raft_mod, "_dots_policy", spy)
    base = _grads(_raft(lookup="lanewise"))
    dots = _grads(_raft(lookup="lanewise", remat=True, remat_policy="dots"))
    nothing = _grads(_raft(lookup="lanewise", remat=True))
    saved = {op for op, d in seen if d == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE}
    assert torch.ops.aten.convolution.default in saved
    assert any(d != torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
               for _, d in seen)
    _assert_bit_equal(base, dots)
    _assert_bit_equal(base, nothing)
    with pytest.raises(ValueError, match="remat_policy"):
        RAFT(small=True, remat_policy="offload")


# --- the declarative layer ------------------------------------------------

B, M, N = 6, 7, 3
FAIL_OFF, FAIL_NAN = 1, 3        # samples whose solve is off the minimum / NaN


def _wls_problem():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(B, M, N)), rng.normal(size=(B, M)),
            rng.uniform(0.5, 2.0, (B, M)), rng.normal(size=(B, N)))


def _wls(xp, solve_fn, swap, at_add, at_set):
    """Weighted least squares ``min_y sum_m w_m ((A y)_m - b_m)^2`` per
    sample, in numpy-like ``xp``: the closed-form solve, made wrong at
    FAIL_OFF (off the minimum) and NaN at FAIL_NAN, and the objective."""
    def solve(xs):
        a, b, w = xs
        at = swap(a) * w[:, None, :]
        y = solve_fn(at @ a, (at @ b[..., None]))[..., 0]
        return at_set(at_add(y, FAIL_OFF, 0.5), FAIL_NAN, float("nan"))

    def objective(xs, y):
        a, b, w = xs
        r = xp.einsum("bmn,bn->bm", a, y) - b
        return (w * r * r).sum(-1)

    return solve, objective


@pytest.mark.parametrize("gamma", [0.0, 0.1])
def test_declarative_layer_matches_jax(gamma):
    """The port's ``make_declarative_layer`` against the JAX package's on a
    weighted least-squares problem, in f64 (JAX's x64 only inside its
    context manager): the forward and the gradients of a linear loss with
    respect to A, b and w agree to 1e-10; the samples whose solve is off
    the minimum (the optimality check fails) or NaN (the Hessian solve is
    not finite) get zero gradients in both."""
    a, b, w, c = _wls_problem()

    def t_add(y, i, v):
        y = y.clone()
        y[i] += v
        return y

    def t_set(y, i, v):
        y = y.clone()
        y[i] = v
        return y

    t_solve, t_obj = _wls(torch, torch.linalg.solve, lambda x: x.transpose(1, 2),
                          t_add, t_set)
    layer = make_declarative_layer(t_solve, t_obj, gamma=gamma)
    xs = tuple(torch.tensor(x, requires_grad=True) for x in (a, b, w))
    y = layer(xs)
    (torch.nan_to_num(y) * torch.tensor(c)).sum().backward()

    with jax.enable_x64(True):
        j_solve, j_obj = _wls(jnp, jnp.linalg.solve,
                              lambda x: jnp.swapaxes(x, 1, 2),
                              lambda y, i, v: y.at[i].add(v),
                              lambda y, i, v: y.at[i].set(v))
        j_layer = j_make_declarative_layer(j_solve, j_obj, gamma=gamma)
        jxs = tuple(jnp.asarray(x) for x in (a, b, w))
        jy = np.asarray(j_layer(jxs))
        jg = jax.grad(lambda v: jnp.sum(jnp.nan_to_num(j_layer(v)) * c))(jxs)
        assert jy.dtype == np.float64
    np.testing.assert_allclose(y.detach().numpy(), jy, rtol=0, atol=1e-10)
    for t, g in zip(xs, jg):
        g = np.asarray(g)
        assert t.grad.dtype == torch.float64
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0, atol=1e-10)
        assert not np.any(g[[FAIL_OFF, FAIL_NAN]])
        assert not torch.any(t.grad[[FAIL_OFF, FAIL_NAN]])
        assert np.abs(g).max() > 1e-3           # the other samples are live
