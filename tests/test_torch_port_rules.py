"""Rules of the port: it never imports JAX, flax, msgpack or the JAX
package, and its entry points never fall back to the CPU on their own."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "robust_pose_tpu_torch"
FORBIDDEN = ("jax", "flax", "robust_pose_tpu", "tests", "msgpack")


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def test_importing_every_module_loads_no_jax():
    """A fresh interpreter imports every module of the port (and runs
    nothing else); afterwards neither jax, flax, msgpack nor robust_pose_tpu
    is in sys.modules, and no cv2, PyYAML, matplotlib, pandas, seaborn,
    open3d or wandb either: the card's machine has none of them, so the
    host data modules import cv2 inside the functions that decode, remap
    or write images, configurations are read by ``utils.config.read_yaml``,
    and the viewers and evaluation CLIs import their plotting, table and
    3D libraries where they use them."""
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'msgpack', 'robust_pose_tpu', 'cv2', "
        "'yaml', 'matplotlib', 'pandas', 'seaborn', 'open3d', 'wandb'))\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in
                                        list(PKG.rglob("*.py"))
                                        + [ROOT / "chip_smoke.py"]))
def test_no_forbidden_import_statement(path):
    """No import statement of the port or of chip_smoke.py names jax, flax,
    msgpack, the JAX package or the tests (including imports inside
    functions)."""
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: import {name}"


def test_no_triton_import():
    """Every kernel of the port is CUDA C++ built by ``ops/_build.py``: no
    module of the port imports Triton, not even inside a function."""
    for path in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert all(n.split(".")[0] != "triton" for n in names), \
                f"{path.relative_to(ROOT)}: import {names}"


def test_entry_points_need_a_device_choice_without_cuda():
    """Without a card and without device='cpu' the entry points raise."""
    from robust_pose_tpu_torch.models.posenet import PoseNet
    from robust_pose_tpu_torch.slam.pose_estimator import PoseEstimator

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: cuda is the default here")
    cfg = {"image_shape": (64, 96), "iters": 1, "unet_levels": 1}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PoseNet(cfg)
    ckpt = {"state_dict": {}, "config": {"model": cfg}}
    slam = {"frame2frame": True, "lbgfs_iters": 5, "conf_weighing": True,
            "depth_clipping": [1, 250]}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PoseEstimator(slam, np.eye(3), 1.0, ckpt, (96, 64))


def test_kernel_wrappers_take_plain_versions_only_on_cpu():
    """A CPU tensor runs the plain version without touching the launch
    counters; a tensor on any other non-CUDA device raises."""
    from robust_pose_tpu_torch.ops import (
        corr_lanewise,
        corr_onthefly,
        corr_pixel,
        instance_norm,
        normal_eq,
    )

    counters = lambda: (corr_onthefly.launches, instance_norm.launches,
                        instance_norm.stats_launches,
                        normal_eq.launches, corr_lanewise.launches,
                        corr_lanewise.bwd_launches, corr_pixel.launches,
                        corr_pixel.grouped_launches)
    before = counters()
    instance_norm.instance_norm_stats(torch.ones(1, 4, 4, 8))
    xn = torch.ones(1, 4, 4, 8, requires_grad=True)
    instance_norm.instance_norm(xn, relu=True).sum().backward()
    instance_norm.instance_norm(torch.ones(1, 4, 4, 8))
    instance_norm.instance_norm_fwd(torch.ones(1, 4, 4, 8), relu=True)
    vol, coords = torch.ones(1, 3, 3, 5), torch.zeros(1, 5, 2)
    corr_lanewise.lanewise_fwd(vol, coords, 4, 1.0)
    corr_lanewise.lanewise_bwd(vol, coords, torch.ones(1, 81, 5), 4, 1.0)
    pvol, pcoords = torch.ones(6, 2, 3), torch.zeros(6, 2)       # K6/K7
    pyr, pyr_coords = [torch.ones(1, 6, 2, 3)], torch.zeros(1, 2, 3, 2)
    corr_pixel.pixel_lookup_level(pvol, pcoords)
    corr_pixel.grouped_lookup_level(pvol, pcoords)
    corr_pixel.pixel_lookup_pyramid(pyr, pyr_coords)
    corr_pixel.grouped_lookup_pyramid(pyr, pyr_coords)
    assert counters() == before
    with pytest.raises(RuntimeError, match="unsupported device"):
        instance_norm.instance_norm_stats(torch.ones(1, 4, 4, 8, device="meta"))
    for norm in (instance_norm.instance_norm, instance_norm.instance_norm_fwd):
        with pytest.raises(RuntimeError, match="unsupported device"):
            norm(torch.ones(1, 4, 4, 8, device="meta"), relu=True)
    meta = lambda t: t.to("meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        corr_lanewise.lanewise_fwd(meta(vol), meta(coords), 4, 1.0)
    with pytest.raises(RuntimeError, match="unsupported device"):
        corr_lanewise.lanewise_bwd(meta(vol), meta(coords),
                                   torch.ones(1, 81, 5, device="meta"), 4, 1.0)
    for fn in (corr_pixel.pixel_lookup_level, corr_pixel.grouped_lookup_level):
        with pytest.raises(RuntimeError, match="unsupported device"):
            fn(meta(pvol), meta(pcoords))
    for fn in (corr_pixel.pixel_lookup_pyramid, corr_pixel.grouped_lookup_pyramid):
        with pytest.raises(RuntimeError, match="unsupported device"):
            fn([meta(pyr[0])], meta(pyr_coords))


# each key with a value the port now implements, and one beside it that
# neither package implements
@pytest.mark.parametrize("key,value", [("small", True), ("dropout", 0.1),
                                       ("remat_policy", "dots")])
def test_unported_config_values_are_refused(key, value):
    """The model keys that once waited for a later slice are taken (the
    model reflects them); a value beside them that neither package
    implements raises by name instead of being ignored."""
    from robust_pose_tpu_torch.models.posenet import PoseNet

    cfg = {"image_shape": (64, 96), "iters": 1, "unet_levels": 1}
    flow = PoseNet({**cfg, key: value}, device="cpu").flow
    assert getattr(flow, key) == value
    bad = {"small": ("lookup", "gather"), "dropout": ("dropout", 1.0),
           "remat_policy": ("remat_policy", "everything")}[key]
    with pytest.raises(ValueError, match=bad[0]):
        PoseNet({**cfg, key: value, bad[0]: bad[1]}, device="cpu")


def test_trainer_needs_a_device_choice_without_cuda():
    from robust_pose_tpu_torch.train.trainer import PoseNetTrainer

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: cuda is the default here")
    cfg = {"model": {"iters": 1, "unet_levels": 1}, "image_shape": [64, 96],
           "train": {}}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PoseNetTrainer(cfg)


@pytest.mark.parametrize("how", ["world1", "torchrun", "init_method"])
def test_make_mesh_needs_a_device_choice_without_cuda(monkeypatch, how):
    """``parallel.mesh.make_mesh`` without a card and without a device
    raises, for a world of 1, under torchrun's environment and with an
    explicit address, before any process group is made."""
    import torch.distributed as dist

    from robust_pose_tpu_torch.parallel.mesh import make_mesh

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: cuda is the default here")
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    kw = {}
    if how == "torchrun":
        for k, v in (("WORLD_SIZE", "2"), ("RANK", "1"), ("LOCAL_RANK", "1"),
                     ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1")):
            monkeypatch.setenv(k, v)
    elif how == "init_method":
        kw = {"init_method": "tcp://127.0.0.1:1", "rank": 0, "world_size": 2}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh(**kw)
    assert not dist.is_initialized()


def test_training_clis_need_a_device_choice_without_cuda(tmp_path):
    """The training CLI (``main`` and ``run``), ``bench_train_step`` and the
    streaming ``bench`` raise without a card unless the CPU is asked for
    (``--force_cpu``, ``--device cpu``), before they read a dataset or
    build a model."""
    from robust_pose_tpu_torch.scripts import bench, bench_train_step, train_posenet

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: cuda is the default here")
    args = train_posenet.build_parser().parse_args(["--outpath", str(tmp_path)])
    assert not args.force_cpu
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_posenet.main(args, {})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_posenet.run(args, {}, [], [])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_train_step.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main([])
    assert train_posenet._device(train_posenet.build_parser().parse_args(
        ["--force_cpu"])) == torch.device("cpu")
