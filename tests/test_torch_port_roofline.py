"""The port's FLOP/byte counter (``utils/costs``) and its roofline
(``scripts/roofline.py``) on the CPU at 64x96, one GRU iteration, one UNet
level.

The counter against hand counts: a convolution's and a product's FLOPs are
2 x their multiply-adds and their bytes the operands plus the outputs,
exactly; RAFT's encoders' FLOPs the analytic sum over their convolutions'
shapes. Each kernel wrapper on the CPU adds exactly its formula and none
of its plain version's ops (K3's solve: the builds of the iterations it
ran). An f2f window counts the same twice, its per-op, per-span and
per-dtype rows summing to the totals; ``roofline --device cpu`` prints
rows with ``null`` times; and without a card and without ``--device cpu``
every new tool raises.
"""
import json

import pytest
import torch
import torch.nn.functional as F

from robust_pose_tpu_torch.scripts import bench, roofline
from robust_pose_tpu_torch.utils import costs

H, W = 64, 96


@pytest.fixture()
def small(monkeypatch):
    """The bench's estimator at 64x96 with 1 GRU iteration and 1 UNet
    level (the 3-level TinyUNet needs ~384x512), bf16 as on the card."""
    monkeypatch.setattr(bench, "H", H)
    monkeypatch.setattr(bench, "W", W)
    monkeypatch.setattr(bench, "MODEL", dict(bench.MODEL, iters=1, unet_levels=1))
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_conv_and_matmul_count_two_flops_a_multiply_add():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 12, 10, generator=g)
    w = torch.randn(16, 8, 3, 3, generator=g)
    b = torch.randn(16, generator=g)
    with costs.count() as c:
        y = F.conv2d(x, w, b, stride=2, padding=1)
    macs = 2 * 16 * y.shape[2] * y.shape[3] * 8 * 9
    assert dict(c.by_op) == {"convolution": [
        2 * macs, 4 * (x.numel() + w.numel() + b.numel() + y.numel()), 1]}
    a, m = torch.randn(3, 5, 7, generator=g), torch.randn(3, 7, 4, generator=g)
    with costs.count() as c:
        z = torch.bmm(a, m)
    assert c.flops == 2 * 3 * 5 * 7 * 4
    assert c.bytes == 4 * (a.numel() + m.numel() + z.numel())
    assert dict(c.by_dtype) == {"f32": [c.flops, c.bytes]}


def test_views_factories_and_broadcasts_count_as_stated():
    """Views and factories read nothing; a zero-stride operand counts its
    distinct elements; ``copy_`` writes its destination without reading
    it; a bf16 product counts under bf16."""
    x = torch.randn(4, 6)
    with costs.count() as c:
        x.view(24)
        x.t()
        torch.empty(100)
        torch.zeros(100)
        row = torch.randn(6)
        y = x + row.expand(4, 6)
        z = torch.empty(4, 6)
        z.copy_(y)
        xb = x.bfloat16()
        xb @ xb.t()
    assert c.by_op["add"][1] == 4 * (24 + 6 + 24)
    assert c.by_op["copy_"][1] == 4 * 24 * 2
    assert "view" not in c.by_op and "empty" not in c.by_op
    assert c.by_dtype["bf16"][0] == 2 * 4 * 6 * 4


def test_raft_encoder_flops_are_the_analytic_sum(small):
    """fnet and cnet on one 64x96 image: the counter's convolution FLOPs
    equal 2 B Cout Ho Wo Cin kh kw summed over every convolution."""
    from robust_pose_tpu_torch.models.raft import RAFT

    raft = RAFT(iters=1, dtype=torch.float32, corr_dtype=torch.float32)
    shapes = []
    hooks = [m.register_forward_hook(
        lambda m, i, o: shapes.append((m, tuple(o.shape))))
        for m in raft.modules() if isinstance(m, torch.nn.Conv2d)]
    img = 255.0 * torch.rand(1, H, W, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad(), costs.count() as c:
        raft.encode_fnet(img)
        raft.encode_cnet(img)
    for h in hooks:
        h.remove()
    want = sum(2 * o[0] * o[1] * o[2] * o[3] * m.in_channels // m.groups
               * m.kernel_size[0] * m.kernel_size[1] for m, o in shapes)
    # an encoder: conv1, 2 in each of 6 residual blocks, 2 downsamples, conv2
    assert len(shapes) == 2 * 16
    assert c.by_op["convolution"][0] == want


def _k1():
    from robust_pose_tpu_torch.ops import corr_onthefly as K1

    g = torch.Generator().manual_seed(2)
    f1 = torch.randn(2, 6 * 8, 128, generator=g).bfloat16()
    levels = K1.pool_fmap_pyramid(torch.randn(2, 6, 8, 128, generator=g), 3)
    levels = [v.bfloat16() for v in levels]
    coords = torch.rand(2, 48, 2, generator=g) * torch.tensor([10.0, 8.0]) - 1.0
    return ("corr_window_lookup",
            lambda: K1.pyramid_forward(f1, levels, coords, 3, grid=(6, 8)),
            costs.corr_window(f1, levels, coords, 3))


def _k1_level():
    from robust_pose_tpu_torch.ops import corr_onthefly as K1

    g = torch.Generator().manual_seed(3)
    f1 = torch.randn(1, 20, 128, generator=g)
    f2 = torch.randn(1, 3, 4, 128, generator=g)
    coords = torch.rand(1, 20, 2, generator=g) * 12.0
    return ("corr_window_lookup",
            lambda: K1.corr_lookup_level(f1, f2, coords, 4, 4.0),
            costs.corr_window(f1, [f2], coords, 4, 4.0))


def _k2():
    from robust_pose_tpu_torch.ops import instance_norm as K2

    x = torch.randn(2, 5, 7, 96).bfloat16()
    return "instance_norm_stats", lambda: K2.instance_norm_stats(x), \
        costs.instance_norm_stats(x)


def _planes(b=2, h=12, w=16, seed=4):
    from robust_pose_tpu_torch import se3
    from robust_pose_tpu_torch.ops import normal_eq as K3
    from robust_pose_tpu_torch.ops.geometry import create_img_coords, depth_to_pcl
    from robust_pose_tpu_torch.solver.objectives import PoseProblemInputs

    g = torch.Generator().manual_seed(seed)
    K = torch.tensor([[20.0, 0, w / 2], [0, 20.0, h / 2], [0, 0, 1.0]]).expand(b, 3, 3)
    coords = create_img_coords(h, w)
    pcl1 = depth_to_pcl(0.3 + torch.rand(b, h, w, 1, generator=g), K, coords)
    pose = se3.exp(0.02 * torch.randn(b, 6, generator=g))
    pp = se3.act(pose[:, None], pcl1.reshape(b, -1, 3))
    proj = pp @ K.transpose(1, 2)
    flow = (proj[..., :2] / proj[..., 2:] - coords[None, :, :2]).reshape(b, h, w, 2)
    ones = torch.ones(b, h, w, 1, dtype=torch.bool)
    xs = PoseProblemInputs(flow=flow + 0.1 * torch.randn(flow.shape, generator=g),
                           pcl1=pcl1, pcl2=pp.reshape(b, h, w, 3),
                           weights1=torch.rand(b, h, w, 1, generator=g),
                           weights2=torch.rand(b, h, w, 1, generator=g),
                           mask1=ones, mask2=ones, intrinsics=K,
                           loss_weight=torch.ones(b, 2))
    planes, kvec = K3.pack_planes(xs, h, w)
    return planes, kvec, xs.loss_weight.contiguous(), h, w


def _k3_build():
    from robust_pose_tpu_torch import se3
    from robust_pose_tpu_torch.ops import normal_eq as K3

    planes, kvec, lw, h, w = _planes()
    pose = se3.identity((2,))
    return "normal_eq", lambda: K3.normal_equations(pose, planes, kvec, lw, h, w), \
        costs.normal_equations(2, h, w)


def _k4(bwd=False):
    from robust_pose_tpu_torch.ops import corr_lanewise as L

    g = torch.Generator().manual_seed(5)
    f1, f2 = (torch.randn(2, 6, 8, 32, generator=g) for _ in range(2))
    vols = L.build_corr_pyramid_t(f1, f2, num_levels=3, dtype=torch.bfloat16)
    coords = (torch.rand(2, 48, 2, generator=g) * 9.0).contiguous()
    if not bwd:
        return "lanewise_lookup", lambda: L.lanewise_fwd_pyramid(vols, coords, 4), \
            costs.lanewise_fwd(vols, coords, 4)
    gr = torch.randn(2, 3 * 81, 48, generator=g)
    return "lanewise_lookup_bwd", \
        lambda: L.lanewise_bwd_pyramid(vols, coords, gr, 4), \
        costs.lanewise_bwd(vols, coords, 4)


def _k6(grouped=False, level=False):
    from robust_pose_tpu_torch.models.raft import build_corr_pyramid
    from robust_pose_tpu_torch.ops import corr_pixel as KP

    g = torch.Generator().manual_seed(6)
    f1, f2 = (torch.randn(1, 8, 16, 32, generator=g) for _ in range(2))
    pyr = build_corr_pyramid(f1, f2, dtype=torch.bfloat16)
    coords = (torch.rand(1, 8, 16, 2, generator=g) * 17.0 - 1.0).contiguous()
    n = 8 * 16
    name = "grouped_lookup" if grouped else "pixel_lookup"
    if level:
        vol, c = pyr[1].reshape(n, *pyr[1].shape[2:]), coords.reshape(n, 2) / 2
        fn = KP.grouped_lookup_level if grouped else KP.pixel_lookup_level
        return name, lambda: fn(vol, c), costs.pixel_lookup([vol], c)
    fn = KP.grouped_lookup_pyramid if grouped else KP.pixel_lookup_pyramid
    return name, lambda: fn(pyr, coords), costs.pixel_lookup(
        [v.reshape(n, *v.shape[2:]) for v in pyr], coords.reshape(n, 2))


CASES = {"K1": _k1, "K1_level": _k1_level, "K2": _k2, "K3_build": _k3_build,
         "K4": _k4, "K5": lambda: _k4(bwd=True), "K6": _k6,
         "K7": lambda: _k6(grouped=True), "K6_level": lambda: _k6(level=True),
         "K7_level": lambda: _k6(grouped=True, level=True)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_wrapper_adds_its_formula_and_nothing_else(case):
    name, call, (flops, nbytes, dt) = CASES[case]()
    with costs.count() as c:
        call()
    assert dict(c.by_op) == {name: [flops, nbytes, 1]}
    assert dict(c.by_dtype) == {dt: [flops, nbytes]}
    assert flops > 0 and nbytes > 0


@pytest.mark.parametrize("early_exit", [True, False])
def test_lm_solve_counts_the_builds_it_ran(early_exit):
    """K3's solve on the CPU (the plain loop, suspended) adds one build for
    each sample's first point and each iteration it ran: (B + sum niter)
    builds of H W 260 operations, the planes read once a build."""
    from robust_pose_tpu_torch.ops import normal_eq as K3
    from robust_pose_tpu_torch.solver.gauss_newton import SolverConfig

    planes, kvec, lw, h, w = _planes(b=3, seed=7)
    with costs.count() as c:
        _, niter = K3.lm_solve(planes, kvec, lw, h, w,
                               SolverConfig(iters=6, early_exit=early_exit))
    builds = 3 + int(niter.sum())
    assert 3 < builds <= 3 * 7
    assert dict(c.by_op) == {"lm_solve": [builds * h * w * 260,
                                          builds * 10 * h * w * 4, 1]}


def test_f2f_window_counts_identically_twice(small):
    """A fresh estimator's first window (2 frames) counts the same FLOPs and
    bytes twice; the per-op, per-span and per-dtype rows sum to the totals,
    the window's four spans are there, and K1, K2 and the LM solve count
    under their spans."""
    c1 = roofline.count_window("f2f", "cpu", 2)
    c2 = roofline.count_window("f2f", "cpu", 2)
    assert (c1.flops, c1.bytes) == (c2.flops, c2.bytes)
    assert dict(c1.by_op) == dict(c2.by_op)
    for rows in (c1.by_op, c1.by_span, c1.by_dtype):
        assert sum(v[0] for v in rows.values()) == c1.flops
        assert sum(v[1] for v in rows.values()) == c1.bytes
    assert {f"infer_window.{s}" for s in ("encode", "flow", "weights", "solve")} \
        <= set(c1.by_span)
    assert c1.by_op["corr_window_lookup"][2] == 1
    assert c1.by_op["instance_norm_stats"][2] == 15
    assert c1.by_op["lm_solve"][2] == 1
    assert c1.by_dtype["bf16"][0] > 0


def test_roofline_prints_rows_with_null_times_on_the_cpu(small, capsys):
    rows = roofline.main(["--device", "cpu", "--window", "2", "--windows", "1",
                          "--by-op", "3"])
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert [r["path"] for r in rows] == ["f2f_window", "f2m_window_iters100"]
    assert lines[:2] == rows
    assert [l["path"] for l in lines[2:]] == [r["path"] for r in rows]
    for r in rows:
        assert r["gflops_per_frame"] > 0 and r["hbm_gb_per_frame"] > 0
        assert r["binding_resource"] in ("compute", "HBM")
        for k in ("measured_ms_per_frame", "mfu_pct", "hbm_util_pct",
                  "overhead_ms", "device", "power_limit"):
            assert r[k] is None, k


TOOLS = ("verify_parity", "roofline", "profile_trace", "profile_stages",
         "profile_f2m", "profile_encoder", "ab_exact_render")


@pytest.mark.parametrize("tool", TOOLS)
def test_every_tool_needs_a_device_choice_without_cuda(tool):
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: cuda is the default here")
    mod = importlib.import_module(f"robust_pose_tpu_torch.scripts.{tool}")
    argv = ["--selftest"] if tool == "verify_parity" else []
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(argv)
