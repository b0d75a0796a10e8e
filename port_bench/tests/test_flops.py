"""The analytic FLOP count against the program's dispatch count
(``utils/costs``) at a small shape on the CPU.

The analytic count's convolutions must equal what the counter files under
``convolution``, ``convolution_backward`` and ``mm`` (the 1x1 correlation
convolution runs as a matrix product), but for the listed differences:

- the counter sees no input gradient where autograd computes none: the
  encoders' 7x7 stem (its input is the image), the motion encoder's first
  flow convolution at iteration 0 (its input, the zero flow, is a
  constant);
- the correlation, the lookup and the convex combination are left out of
  the comparison: the program's lookup on the CPU is a one-hot matrix
  product, counted as such, where the analytic count takes the bilinear
  taps the lookup needs.
"""
from pathlib import Path

import pytest
import torch

from port_bench import cells, flops, traffic
from port_bench.tests.conftest import SMALL

ROOT = Path(__file__).resolve().parents[2]
BENCH = cells.benchmark(ROOT)
CPU = torch.device("cpu")


def _products(counter):
    return sum(v[0] for k, v in counter.by_op.items()
               if k.startswith(("convolution", "mm")))


def _cell(workload):
    conf = next(w["config"] for w in BENCH["workloads"] if w["name"] == workload)
    return cells.load_cell(BENCH, workload, 3, CPU, SMALL[conf])


def test_window_products_equal():
    from robust_pose_tpu_torch.utils import costs

    cell = _cell("f2f.stream8")
    drv = cells.generator(cell)
    drv.setup(0.1)
    with costs.count() as c:
        drv._read(drv._dispatch(keep=False))
    want = flops.work_breakdown(cell.cfg, drv.work())["conv"]
    assert _products(c) == pytest.approx(want, rel=1e-12)


def test_step_products_equal_but_listed():
    """The published job: RAFT's backward computed."""
    from robust_pose_tpu_torch.utils import costs

    cell = _cell("train.b8")
    drv = cells.generator(cell)
    drv.setup(0.1)
    with costs.count() as c:
        drv._step()
    work = drv.work()
    H, W = cell.cfg["image_shape"]
    h, w = H // 8, W // 8
    stem = flops.conv(3, 64, 7, 7, (H - 1) // 2 + 1, (W - 1) // 2 + 1)
    listed = ((work["fnet"] + work["cnet"]) * stem
              + work["pairs"] * flops.conv(2, 128, 7, 7, h, w))
    want = flops.work_breakdown(cell.cfg, work)["conv"] - listed
    assert _products(c) == pytest.approx(want, rel=1e-12)


def test_full_size_window_count():
    """The published f2f window's count (512x640, 8 frames): a few hundred
    GFLOP a frame, convolutions the most of it."""
    cfg = cells.load_json(ROOT / "port_bench" / "configs" / "f2f.json")
    work = {"pairs": 16, "fnet": 16, "cnet": 8, "heads": 8, "backward": False}
    b = flops.work_breakdown(cfg, work)
    per_frame = sum(b.values()) / 8
    assert 1e11 < per_frame < 2e12
    assert b["conv"] > b["corr"] > b["lookup"]


def test_byte_bounds_follow_the_shapes():
    assert flops.corr_window_bytes(16, 512, 640) == pytest.approx(
        16 * (5120 * 256 * 2 + (5120 + 1280 + 320 + 80) * 256 * 2
              + 5120 * 8 + 4 * 81 * 5120 * 4))
    shapes = flops.fnet_norm_shapes(512, 640)
    assert len(shapes) == 15 and shapes[0] == (64, 256, 320)
    assert shapes[-1] == (128, 64, 80)
    fwd = flops.instance_norm_bytes(32, 512, 640, backward=False)
    both = flops.instance_norm_bytes(32, 512, 640, backward=True)
    assert 1.4 < both / fwd < 1.6


def test_weights_follow_the_reference_names():
    from robust_pose_tpu_torch.models.posenet import PoseNet

    cell = _cell("f2f.stream8")
    model = PoseNet(dict(cell.cfg["model"], image_shape=tuple(cell.cfg["image_shape"])),
                    device="cpu")
    w = traffic.weights(1, cell.cfg, "cpu")
    sd = model.state_dict()
    assert set(w) == set(sd)
    assert all(w[k].shape == sd[k].shape for k in w)
