"""The training slice's operations against the JAX package on the CPU, f32
unless stated: the lane-wise lookup's plain versions (K4 and K5) against
the Pallas kernels in interpret mode, the new backwards of K1 and K2, the
"xla" lookup, train-mode BatchNorm, the IFT pose layer, and the gradient
repairs of the port's layers (each of those tests fails without its
repair: the weight gradient was missing)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from robust_pose_tpu.models.raft import (
    _SplitConv1x1 as JSplitConv1x1,
    SepConvGRU as JSepConvGRU,
    build_corr_pyramid as j_build_corr_pyramid,
    lookup_corr as j_lookup_corr,
)
from robust_pose_tpu.ops.geometry import create_img_coords as j_img_coords
from robust_pose_tpu.ops.pallas_corr_onthefly import (
    onthefly_lookup as j_onthefly_lookup,
    pool_fmap_pyramid as j_pool,
)
from robust_pose_tpu.ops.pallas_instance_norm import (
    instance_norm as j_instance_norm,
    instance_norm_stats as j_stats,
)
from robust_pose_tpu.ops.pallas_lookup_lanewise import (
    build_corr_pyramid_t as j_build_t,
    lanewise_lookup_level as j_lanewise_level,
)
from robust_pose_tpu.ops.warp import warp_pcl_mask as j_warp_pcl_mask
from robust_pose_tpu.solver.gauss_newton import (
    SolverConfig as JSolverConfig,
    make_pose_layer,
)
from robust_pose_tpu_torch.models.layers import BatchNorm, Conv2d
from robust_pose_tpu_torch.models.raft import SepConvGRU, SplitConv1x1
from robust_pose_tpu_torch.models.raft import build_corr_pyramid, lookup_corr
from robust_pose_tpu_torch.ops import corr_lanewise, corr_onthefly, instance_norm
from robust_pose_tpu_torch.ops.warp import warp_pcl_mask
from robust_pose_tpu_torch.solver.gauss_newton import SolverConfig, pose_layer
from tests.test_torch_port_common import jax_variables, random_state_dict
from tests.test_torch_port_kernels import as_jax, as_port, solver_problem
from tests.test_torch_port_ops import _warp_inputs


def _value_and_vjp(f, args, ct):
    """``f(*args)`` and its cotangents for ``ct``, in one jitted call."""
    def run(args, ct):
        out, vjp = jax.vjp(f, *args)
        return out, vjp(ct)

    return jax.jit(run)(args, ct)


def _grid(b, h, w):
    yg, xg = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    return np.tile(np.stack([xg, yg], -1).reshape(1, h * w, 2), (b, 1, 1))


def _coords(case, b, h, w, rng):
    base = _grid(b, h, w)
    c = base + rng.normal(0, 2.5, base.shape)
    if case == "out_of_level":
        c[:, ::3] = c[:, ::3] * 3.0 - 40.0      # windows partly or wholly off
    return c.astype(np.float32)


# --- K4 / K5: lane-wise lookup ------------------------------------------------

@pytest.mark.parametrize("case,dtype", [("shifted", "f32"), ("out_of_level", "f32"),
                                        ("ragged", "f32"), ("shifted", "bf16"),
                                        ("out_of_level", "bf16")])
def test_lanewise_plain_matches_pallas(case, dtype):
    """Levels 0 and 1 of a transposed pyramid; N = 9 * 11 = 99 for
    "ragged" (no multiple of the Pallas kernel's 128 lanes), 12 * 16 = 192
    otherwise. Forward and both cotangents: f32 atol 1e-5 (the same f32
    products, summed in other orders); with a bf16 volume both read the
    same bf16 taps into f32, and dcorr is rounded to bf16 once on each
    side: rtol 2^-7 for it."""
    rng = np.random.default_rng(len(case) + (dtype == "bf16"))
    b, h8, w8, c = (2, 9, 11, 8) if case == "ragged" else (2, 12, 16, 8)
    f1, f2 = (rng.normal(size=(b, h8, w8, c)).astype(np.float32) for _ in range(2))
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    pj = j_build_t(jnp.asarray(f1), jnp.asarray(f2), dtype=jdt)
    pt = corr_lanewise.build_corr_pyramid_t(torch.from_numpy(f1),
                                            torch.from_numpy(f2), dtype=tdt)
    assert [tuple(p.shape) for p in pt] == [p.shape for p in pj]
    coords = _coords(case, b, h8, w8, rng)
    for lvl in (0, 1):
        s = 2 ** lvl
        vol = np.asarray(pj[lvl].astype(jnp.float32))
        np.testing.assert_allclose(pt[lvl].float().numpy(), vol, rtol=1e-2 if
                                   dtype == "bf16" else 1e-6, atol=1e-6)
        g = rng.normal(size=(b, 81, h8 * w8)).astype(np.float32)
        out, (dcorr_j, dco_j) = _value_and_vjp(
            lambda v, cc: j_lanewise_level(v, cc, 4, s, True),
            (pj[lvl], jnp.asarray(coords)), jnp.asarray(g))
        vt = torch.from_numpy(vol).to(tdt)
        ct = torch.from_numpy(coords)
        got = corr_lanewise.lanewise_fwd_plain(vt, ct, 4, s)
        dcorr, dco = corr_lanewise.lanewise_bwd_plain(vt, ct, torch.from_numpy(g), 4, s)
        assert dcorr.dtype == tdt and tuple(dco.shape) == (b, h8 * w8, 2)
        np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=1e-5,
                                   err_msg=f"forward, level {lvl}")
        np.testing.assert_allclose(
            dcorr.float().numpy(), np.asarray(dcorr_j.astype(jnp.float32)),
            rtol=2 ** -7 if dtype == "bf16" else 0, atol=1e-5, err_msg=f"dcorr {lvl}")
        scale = np.abs(np.asarray(dco_j)).max()
        np.testing.assert_allclose(dco.numpy(), np.asarray(dco_j), rtol=0,
                                   atol=1e-5 * scale, err_msg=f"dcoords {lvl}")


def test_lanewise_autograd_function_matches_plain_pair():
    """``lanewise_lookup_level`` on CPU tensors: its forward is the plain K4,
    its backward the plain K5 (with respect to both inputs), and neither
    launch counter moves."""
    rng = np.random.default_rng(4)
    b, hl, wl, n = 2, 5, 7, 30
    vol = torch.from_numpy(rng.normal(size=(b, hl, wl, n)).astype(np.float32))
    coords = torch.from_numpy(rng.uniform(-3, 12, (b, n, 2)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(b, 81, n)).astype(np.float32))
    before = (corr_lanewise.launches, corr_lanewise.bwd_launches)
    v, c = vol.clone().requires_grad_(), coords.clone().requires_grad_()
    out = corr_lanewise.lanewise_lookup_level(v, c, 4, 2.0)
    out.backward(g)
    assert torch.equal(out.detach(), corr_lanewise.lanewise_fwd_plain(vol, coords, 4, 2.0))
    dv, dc = corr_lanewise.lanewise_bwd_plain(vol, coords, g, 4, 2.0)
    assert torch.equal(v.grad, dv) and torch.equal(c.grad, dc)
    assert (corr_lanewise.launches, corr_lanewise.bwd_launches) == before


def test_lanewise_backward_matches_finite_differences():
    """K5's cotangents are the derivatives of K4: central differences in
    f64 arithmetic on the f32 plain versions, at centres away from tap
    boundaries (rtol 1e-3)."""
    rng = np.random.default_rng(5)
    b, hl, wl, n = 1, 6, 6, 4
    vol = torch.from_numpy(rng.normal(size=(b, hl, wl, n)).astype(np.float32))
    coords = torch.from_numpy(np.float32([[[2.3, 1.6], [0.4, 3.7],
                                           [-2.6, 4.2], [5.5, 5.3]]]))
    g = torch.from_numpy(rng.normal(size=(b, 81, n)).astype(np.float32))
    _, dc = corr_lanewise.lanewise_bwd_plain(vol, coords, g, 4, 1.0)
    h = 1e-2
    for axis in (0, 1):
        e = torch.zeros_like(coords)
        e[..., axis] = h
        f = lambda cc: (corr_lanewise.lanewise_fwd_plain(vol, cc, 4, 1.0).double()
                        * g.double()).sum((0, 1))
        fd = (f(coords + e) - f(coords - e)) / (2 * h)
        np.testing.assert_allclose(dc[0, :, axis].numpy(), fd.numpy(), rtol=1e-3,
                                   atol=1e-4)


# --- K1's backward and K2's backward ------------------------------------------

def test_onthefly_backward_matches_jax_vjp(monkeypatch):
    """Cotangents of (f1, f2 levels, coords) through all 4 levels against
    ``jax.vjp`` of the Pallas lookup (its custom VJP): atol 1e-4 of each
    cotangent's scale (f32 sums over the level slab in other orders). The
    forward is made to return a tensor without autograd history, as the
    kernel's launch does on the card, so the gradient must come from the
    lookup's own backward (the pyramid ``autograd.Function``'s)."""
    forward = corr_onthefly.pyramid_forward
    monkeypatch.setattr(corr_onthefly, "pyramid_forward",
                        lambda *a: forward(*a).detach())
    rng = np.random.default_rng(6)
    b, h8, w8, c = 2, 10, 12, 8
    f1 = rng.normal(size=(b, h8, w8, c)).astype(np.float32)
    f2 = rng.normal(size=(b, h8, w8, c)).astype(np.float32)
    coords = (_grid(b, h8, w8) + rng.normal(0, 2.0, (b, h8 * w8, 2))
              ).reshape(b, h8, w8, 2).astype(np.float32)
    gs = [rng.normal(size=(b, 81, h8 * w8)).astype(np.float32) for _ in range(4)]
    levels_j = j_pool(jnp.asarray(f2))
    _, (df1_j, dls_j, dco_j) = _value_and_vjp(
        lambda a, ls, cc: j_onthefly_lookup(a, ls, cc, interpret=True),
        (jnp.asarray(f1), levels_j, jnp.asarray(coords)),
        [jnp.asarray(g) for g in gs])
    t1 = torch.from_numpy(f1).requires_grad_()
    tls = [torch.from_numpy(np.asarray(l)).requires_grad_() for l in levels_j]
    tc = torch.from_numpy(coords).requires_grad_()
    outs = corr_onthefly.onthefly_lookup(t1, tls, tc)
    torch.autograd.backward(outs, [torch.from_numpy(g) for g in gs])
    pairs = [(t1.grad, df1_j), (tc.grad, dco_j)] + [
        (t.grad, d) for t, d in zip(tls, dls_j)]
    for got, ref in pairs:
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("reference", ["autodiff", "custom_vjp"])
def test_instance_norm_stats_backward_matches_jax(reference, monkeypatch):
    """The port's stats backward (dx = gs + 2 x gss) against JAX: the
    gradient of ``instance_norm`` (autodiff of its CPU formulation), and the
    Pallas stats' custom VJP in interpret mode. rtol 1e-4. The stats are
    made to come back without autograd history, as the kernel's do
    on the card, so the gradient must come from the stats' own backward."""
    plain = instance_norm.instance_norm_stats_plain
    monkeypatch.setattr(instance_norm, "instance_norm_stats_plain",
                        lambda x: tuple(t.detach() for t in plain(x)))
    rng = np.random.default_rng(7)
    x = rng.normal(0.3, 1.5, size=(2, 8, 12, 64)).astype(np.float32)
    if reference == "autodiff":
        ct = rng.normal(size=x.shape).astype(np.float32)
        ref = jax.grad(lambda a: jnp.sum(j_instance_norm(a) * ct))(jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_()
        (instance_norm.instance_norm(xt) * torch.from_numpy(ct)).sum().backward()
    else:
        gs, gss = (rng.normal(size=(2, 64)).astype(np.float32) for _ in range(2))
        _, (ref,) = _value_and_vjp(lambda a: j_stats(a, True), (jnp.asarray(x),),
                                   (jnp.asarray(gs), jnp.asarray(gss)))
        xt = torch.from_numpy(x).requires_grad_()
        s, ss = instance_norm.instance_norm_stats(xt)
        torch.autograd.backward([s, ss], [torch.from_numpy(gs), torch.from_numpy(gss)])
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(ref)).max())


# --- the "xla" lookup ----------------------------------------------------------

def test_xla_lookup_matches_jax():
    """``build_corr_pyramid`` + ``lookup_corr`` (one-hot products) against
    the JAX package's, forward and the cotangents of the features and the
    coords: atol 1e-5 forward, 1e-4 of the scale for the cotangents."""
    rng = np.random.default_rng(8)
    b, h8, w8, c = 2, 10, 12, 8
    f1, f2 = (rng.normal(size=(b, h8, w8, c)).astype(np.float32) for _ in range(2))
    coords = (_grid(b, h8, w8) + rng.normal(0, 3.0, (b, h8 * w8, 2))
              ).reshape(b, h8, w8, 2).astype(np.float32)
    g = rng.normal(size=(b, h8, w8, 4 * 81)).astype(np.float32)

    def jf(a, bb, cc):
        return j_lookup_corr(j_build_corr_pyramid(a, bb), cc)

    with jax.default_matmul_precision("float32"):
        out, refs = _value_and_vjp(jf, tuple(map(jnp.asarray, (f1, f2, coords))),
                                   jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in (f1, f2, coords)]
    got = lookup_corr(build_corr_pyramid(ts[0], ts[1]), ts[2])
    # port: per-level (B, 81, N); JAX: (B, H, W, 4 * 81)
    got_nhwc = torch.cat([o.transpose(1, 2) for o in got], -1).reshape(b, h8, w8, -1)
    np.testing.assert_allclose(got_nhwc.detach().numpy(), np.asarray(out), atol=1e-5)
    got_nhwc.backward(torch.from_numpy(g))
    for t, ref in zip(ts, refs):
        ref = np.asarray(ref)
        np.testing.assert_allclose(t.grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())


# --- train-mode BatchNorm ------------------------------------------------------

def test_batchnorm_train_matches_flax():
    """flax ``BatchNorm(use_running_average=False)``: output, the running
    statistics after one update (momentum 0.99, biased variance) and the
    gradients of the input, scale and bias; f32 rtol 1e-5."""
    import flax.linen as fnn

    rng = np.random.default_rng(9)
    x = rng.normal(0.4, 2.0, size=(3, 5, 6, 8)).astype(np.float32)   # NHWC
    ct = rng.normal(size=x.shape).astype(np.float32)
    bn = BatchNorm(8)
    sd = random_state_dict(bn, seed=9)
    bn.load_state_dict(sd)
    a = {k: jnp.asarray(v.numpy()) for k, v in sd.items()}
    params = {"scale": a["weight"], "bias": a["bias"]}
    stats0 = {"mean": a["running_mean"], "var": a["running_var"]}
    jbn = fnn.BatchNorm(use_running_average=False)

    def jloss(params, xx):
        y, upd = jbn.apply({"params": params, "batch_stats": stats0},
                           xx, mutable=["batch_stats"])
        return jnp.sum(y * ct), (y, upd["batch_stats"])

    (_, (yj, stats)), (gp, gx) = jax.value_and_grad(jloss, (0, 1), has_aux=True)(
        params, jnp.asarray(x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y = bn(xt, train=True)
    (y * torch.from_numpy(ct).permute(0, 3, 1, 2)).sum().backward()
    close = lambda a, r: np.testing.assert_allclose(a, np.asarray(r), rtol=1e-5, atol=1e-5)
    close(y.detach().permute(0, 2, 3, 1).numpy(), yj)
    close(bn.running_mean.numpy(), stats["mean"])
    close(bn.running_var.numpy(), stats["var"])
    close(xt.grad.permute(0, 2, 3, 1).numpy(), gx)
    close(bn.weight.grad.numpy(), gp["scale"])
    close(bn.bias.grad.numpy(), gp["bias"])


# --- the IFT pose layer --------------------------------------------------------

FIELDS = ("flow", "pcl1", "pcl2", "weights1", "weights2", "intrinsics",
          "loss_weight")


@pytest.mark.parametrize("case", ["optimal", "one_not_optimal"])
def test_pose_layer_gradients_match_jax(case):
    """Gradients of a random linear function of tau6 with respect to every
    floating input, against the JAX ``make_pose_layer``. "optimal": 20 LM
    iterations, both samples pass the optimality check (max |dE/deps| <=
    1e-3). "one_not_optimal": 2 iterations on a noisy problem whose second
    sample carries loss weights x100: it fails the check, and its input
    gradients are exactly zero in both packages. rtol 1e-3 of each field's
    scale (the Hessian solve at LM solutions that agree to ~1e-6)."""
    h, w = 24, 32
    iters, sigma, lw1 = (20, 0.02, 1.0) if case == "optimal" else (2, 0.2, 100.0)
    p = solver_problem(h=h, w=w, seed=3, sigma=sigma)
    p["loss_weight"][1] *= lw1
    ct = np.random.default_rng(10).normal(size=(2, 6)).astype(np.float32)
    layer = make_pose_layer(j_img_coords(h, w), JSolverConfig(iters=iters))

    def jf(xs):
        return jnp.sum(layer(xs)[1] * ct)

    with jax.default_matmul_precision("float32"):
        gj = jax.jit(jax.grad(jf, allow_int=True))(as_jax(p))
    xs = as_port(p)
    xs = xs._replace(**{k: getattr(xs, k).requires_grad_() for k in FIELDS})
    _, tau, _ = pose_layer(xs, SolverConfig(iters=iters))
    (tau * torch.from_numpy(ct)).sum().backward()
    for k in FIELDS:
        ref = np.asarray(getattr(gj, k))
        got = getattr(xs, k).grad.numpy()
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-3 * np.abs(ref).max() + 1e-12, err_msg=k)
        if case == "one_not_optimal":
            # the first sample's flows leave the image: its 2D term (flow,
            # weights1, intrinsics) is empty, its 3D term carries gradients
            assert k in ("flow", "weights1", "intrinsics") or np.abs(ref[0]).max() > 0, k
            assert not ref[1].any() and not got[1].any(), k


# --- repairs: gradients through the port's layers -------------------------------

def test_bf16_conv2d_passes_weight_gradient():
    """A bf16 ``Conv2d`` (f32 parameters) returns the weight and bias
    gradients of the convolution with bf16-cast parameters, in f32, the
    same values as autograd through an explicit cast."""
    rng = np.random.default_rng(11)
    conv = Conv2d(6, 4, 3, 1, 1, torch.bfloat16)
    x = torch.from_numpy(rng.normal(size=(2, 6, 5, 7)).astype(np.float32))
    ct = torch.from_numpy(rng.normal(size=(2, 4, 5, 7)).astype(np.float32))
    (conv(x).float() * ct).sum().backward()
    w = conv.weight.detach().clone().requires_grad_()
    bias = conv.bias.detach().clone().requires_grad_()
    ref = F.conv2d(x.bfloat16(), w.bfloat16(), bias.bfloat16(), padding=1)
    (ref.float() * ct).sum().backward()
    assert conv.weight.grad is not None and conv.weight.grad.abs().max() > 0
    assert torch.equal(conv.weight.grad, w.grad)
    assert torch.equal(conv.bias.grad, bias.grad)


def test_sep_conv_gru_passes_weight_gradients():
    """``SepConvGRU`` runs z and r as one convolution with concatenated
    kernels; every kernel and bias (convz*, convr* included) gets the
    gradient of the JAX module's (rtol 1e-4 of each leaf's scale)."""
    rng = np.random.default_rng(13)
    port = SepConvGRU(hidden_dim=16, input_dim=24)
    h = np.tanh(rng.normal(size=(2, 6, 8, 16))).astype(np.float32)      # NHWC
    x = rng.normal(size=(2, 6, 8, 24)).astype(np.float32)
    ct = rng.normal(size=(2, 6, 8, 16)).astype(np.float32)
    sd = random_state_dict(port, seed=13)
    port.load_state_dict(sd)
    params = jax_variables(sd)["params"]
    with jax.default_matmul_precision("float32"):
        gj = jax.grad(lambda prm: jnp.sum(JSepConvGRU(hidden_dim=16).apply(
            {"params": prm}, jnp.asarray(h), jnp.asarray(x)) * ct))(params)
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)
    out = port(nchw(h), nchw(x))
    (out * nchw(ct)).sum().backward()
    _assert_param_grads(port, gj)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_split_conv1x1_passes_weight_gradient(dtype):
    """``SplitConv1x1`` over (B, C, N) parts slices one kernel. f32: the
    kernel and bias get the JAX module's gradients (rtol 1e-4 of the
    scale). bf16 (mixed precision): the same gradients, bit for bit, as
    autograd through an explicit cast of the f32 parameters."""
    rng = np.random.default_rng(14)
    port = SplitConv1x1(2 * 81, 32, torch.bfloat16 if dtype == "bf16" else
                        torch.float32)
    parts = [rng.normal(size=(2, 81, 6 * 8)).astype(np.float32) for _ in range(2)]
    ct = rng.normal(size=(2, 6, 8, 32)).astype(np.float32)
    sd = random_state_dict(port, seed=14)
    port.load_state_dict(sd)
    out = port([torch.from_numpy(a) for a in parts], (6, 8))
    (out.float() * torch.from_numpy(ct).permute(0, 3, 1, 2)).sum().backward()
    if dtype == "bf16":
        w = sd["weight"].clone().requires_grad_()
        b = sd["bias"].clone().requires_grad_()
        k = w.bfloat16()[:, :, 0, 0].t()
        ref = sum(torch.from_numpy(a).bfloat16().transpose(1, 2) @ k[81 * i:81 * (i + 1)]
                  for i, a in enumerate(parts)) + b.bfloat16()
        (ref.float() * torch.from_numpy(ct).reshape(2, 48, 32)).sum().backward()
        assert port.weight.grad.abs().max() > 0
        assert torch.equal(port.weight.grad, w.grad)
        assert torch.equal(port.bias.grad, b.grad)
        return
    params = {"kernel": jnp.asarray(sd["weight"].numpy().transpose(2, 3, 1, 0)),
              "bias": jnp.asarray(sd["bias"].numpy())}
    with jax.default_matmul_precision("float32"):
        gj = jax.grad(lambda prm: jnp.sum(JSplitConv1x1(32, 2 * 81).apply(
            {"params": prm}, [jnp.asarray(a) for a in parts], (6, 8)) * ct))(params)
    _assert_param_grads(port, {"": gj})


def _assert_param_grads(port, gj):
    """Port parameter gradients against a flax gradient tree (kernel
    (kh, kw, I, O) -> weight (O, I, kh, kw))."""
    for name, prm in port.named_parameters():
        *mods, leaf = name.split(".")
        tree = gj
        for m in mods or [""]:
            tree = tree[m]
        ref = np.asarray(tree["kernel" if leaf == "weight" else "bias"])
        if ref.ndim == 4:
            ref = ref.transpose(3, 2, 0, 1)
        assert prm.grad is not None, name
        np.testing.assert_allclose(prm.grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=name)


def test_warp_pcl_mask_passes_depth_gradient():
    """The mask rides in the depth's lowest mantissa bit; the gradient
    treats that packing as the identity in depth, as the JAX package's
    custom JVP does: depth and flow cotangents rtol 1e-4 of the scale."""
    K, depth, mask, flow = _warp_inputs(seed=3)
    ct = np.random.default_rng(15).normal(size=depth.shape[:3] + (3,)).astype(np.float32)
    _, refs = _value_and_vjp(
        lambda d, f: j_warp_pcl_mask(d, jnp.asarray(mask), f, jnp.asarray(K))[0],
        (jnp.asarray(depth), jnp.asarray(flow)), jnp.asarray(ct))
    d = torch.from_numpy(depth).requires_grad_()
    f = torch.from_numpy(flow).requires_grad_()
    pcl, _ = warp_pcl_mask(d, torch.from_numpy(mask), f, torch.from_numpy(K))
    (pcl * torch.from_numpy(ct)).sum().backward()
    for t, ref in ((d, refs[0]), (f, refs[1])):
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(t.grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())
