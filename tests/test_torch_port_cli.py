"""The port's trajectory-inference CLI (``robust_pose_tpu_torch.scripts.
infer_trajectory``) on the CPU against the JAX CLI (``scripts/
infer_trajectory.py``): the same PNG sequence (tests/test_infer_cli.py's
recipe, 64x96, 5 frames numbered so that the evaluation's offset of -4
sees every one) and the same JAX ``save_checkpoint`` directory, read by
the port's ``load_checkpoint_any``; per frame, ``--window 4``, f2m with
``--window 4``, and a raw mp4 with ``--device-preproc``.

The two ``trajectory.freiburg`` files must have the same timestamps and
poses within 1e-4 tangent distance at the 1/250 depth scale; the printed
ATE/RPE agree within 0.05 mm / 0.01 deg; in f2m the surfel summary line
is equal.
"""
import contextlib
import io
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_pose_tpu import se3 as jse3
from robust_pose_tpu.utils.trajectory import read_freiburg
from tests.test_torch_port_data import write_png_sequence, write_video_sequence

H, W = 64, 96
POSE_TOL = 1e-4           # tangent distance at the 1/250 depth scale
ATE_TOL_MM = 0.05
RPE_ROT_TOL_DEG = 0.01

F2F = {"frame2frame": True, "checkpoint": None, "dist_thr": 0.05,
       "depth_clipping": [1, 250], "debug": False, "conf_weighing": False,
       "average_pts": False, "lbgfs_iters": 5}
F2M = dict(F2F, frame2frame=False, dist_thr=50.0, map_capacity=8 * H * W)
CASES = {
    "per_frame": ("png", F2F, 1, False),
    "window4": ("png", F2F, 4, False),
    "f2m_window4": ("png", F2M, 4, False),
    "video_device_preproc": ("video", F2F, 4, True),
}


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    png = write_png_sequence(tmp_path_factory.mktemp("cli_png"), first=5)
    video = write_video_sequence(tmp_path_factory.mktemp("cli_vid"), n=5,
                                 specular=True)
    # the video's frames carry the stamps 100..104 (video.json); the
    # ground truth of frame k at stamp k - 4
    with open(os.path.join(video, "groundtruth.txt"), "w") as f:
        f.write("\n".join(f"{96 + i} {0.001 * i} 0.0 0.0 0.0 0.0 0.0 1.0"
                          for i in range(6)) + "\n")
    return {"png": png, "video": video}


@pytest.fixture(scope="module")
def checkpoint_dir(tmp_path_factory):
    """tests/test_infer_cli.py's JAX checkpoint: random PoseNet weights
    (2 GRU iterations, no weight heads) with the flow head's bias set; in
    f32 (``mixed_precision`` off), so that the two packages compute the
    same thing to f32 rounding."""
    from robust_pose_tpu.models.posenet import PoseNet
    from robust_pose_tpu.utils.checkpoints import save_checkpoint

    model_cfg = {"image_shape": (H, W), "iters": 2, "lbgfs_iters": 5,
                 "use_weights": False, "mixed_precision": False}
    img = jnp.zeros((1, H, W, 3))
    K = jnp.array([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1.0]])[None]
    variables = PoseNet(model_cfg).init(jax.random.PRNGKey(0), img, img, K,
                                        jnp.asarray([1.0]), img, img)
    variables["params"]["flow"]["update"]["update_block"]["flow_head"][
        "conv2"]["bias"] = jnp.array([-2.5, 0.0])
    d = tmp_path_factory.mktemp("cli_ckpt") / "posenet"
    save_checkpoint(str(d), variables, {"model": model_cfg})
    return str(d)


def _args(input_dir, checkpoint, outpath, window, device_preproc, **kw):
    ns = {"input": input_dir, "checkpoint": checkpoint, "outpath": outpath,
          "start": 0, "stop": 10000, "step": 1, "log": None, "viewer": "none",
          "block_viewer": False, "profile": False, "window": window,
          "device_preproc": device_preproc}
    ns.update(kw)
    return type("Args", (), ns)


def _config(slam):
    return {"slam": dict(slam), "img_size": [W, H], "rect_mode": "conventional"}


def _run(main, args, config):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        outpath = main(args, config)
    return outpath, out.getvalue()


@pytest.fixture(scope="module")
def runs(data_dirs, checkpoint_dir, tmp_path_factory):
    """Each case through the JAX CLI and the port's (device 'cpu'):
    (outpath, stdout) by case and package."""
    from robust_pose_tpu_torch.scripts.infer_trajectory import main as port_main
    from scripts.infer_trajectory import main as jax_main

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    out = {}
    try:
        for case, (data, slam, window, pre) in CASES.items():
            root = tmp_path_factory.mktemp(f"cli_{case}")
            for pkg, main in (("jax", jax_main), ("port", port_main)):
                args = _args(data_dirs[data], checkpoint_dir,
                             str(root / pkg), window, pre, device="cpu")
                out[case, pkg] = _run(main, args, _config(slam))
    finally:
        torch.set_num_threads(n)
    return out


def _tangent_distance(a, b):
    a, b = (jse3.scale(jnp.asarray(x, jnp.float32), 1.0 / 250.0) for x in (a, b))
    return float(np.abs(np.asarray(jse3.log(jse3.mul(jse3.inv(a), b)))).max())


def _metrics(stdout):
    m = re.search(r"ATE/RMSE: (\S+) mm  RPE/trans: (\S+) mm  RPE/rot: (\S+) deg",
                  stdout)
    assert m, stdout
    return [float(v) for v in m.groups()]


@pytest.mark.parametrize("case", list(CASES))
def test_trajectory_matches_jax_cli(runs, case):
    """Same timestamps; every pose within 1e-4 tangent distance."""
    paths = {pkg: os.path.join(runs[case, pkg][0], "trajectory.freiburg")
             for pkg in ("jax", "port")}
    (pj, sj), (pp, sp) = (read_freiburg(paths[k], ret_stamps=True)
                          for k in ("jax", "port"))
    assert len(pp) == 6                     # the initial pose and 5 frames
    np.testing.assert_array_equal(sp, sj)
    assert np.isfinite(pp).all()
    for i in range(len(pp)):
        assert _tangent_distance(pp[i], pj[i]) <= POSE_TOL, (case, i)


@pytest.mark.parametrize("case", list(CASES))
def test_printed_ate_rpe_match_jax_cli(runs, case):
    """The printed ATE/RMSE and RPE of the two CLIs, over 5 compared
    frames, within 0.05 mm and 0.01 deg; both runs finish."""
    (ja, jt, jr), (pa, pt, pr) = (_metrics(runs[case, k][1]) for k in ("jax", "port"))
    assert np.isfinite([pa, pt, pr]).all()
    assert abs(pa - ja) <= ATE_TOL_MM and abs(pt - jt) <= ATE_TOL_MM
    assert abs(pr - jr) <= RPE_ROT_TOL_DEG
    assert runs[case, "port"][1].rstrip().endswith("finished")


def test_f2m_surfel_summary_and_plys_match_jax_cli(runs):
    lines = {k: [ln for ln in runs["f2m_window4", k][1].splitlines()
                 if ln.startswith("surfels: ")] for k in ("jax", "port")}
    assert len(lines["port"]) == 1 and lines["port"] == lines["jax"]
    for name in ("stable_map.ply", "all_map.ply"):
        assert (os.path.isfile(os.path.join(runs["f2m_window4", "port"][0], name))
                == os.path.isfile(os.path.join(runs["f2m_window4", "jax"][0], name)))


def test_viewer_is_refused(data_dirs, checkpoint_dir, tmp_path):
    from robust_pose_tpu_torch.scripts.infer_trajectory import main

    args = _args(data_dirs["png"], checkpoint_dir, str(tmp_path), 1, False,
                 viewer="2d", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md, queue A"):
        main(args, _config(F2F))


def test_no_device_on_a_cpu_only_host_raises(data_dirs, checkpoint_dir, tmp_path):
    from robust_pose_tpu_torch.scripts.infer_trajectory import build_parser, main

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    args = build_parser().parse_args([data_dirs["png"], "--checkpoint",
                                      checkpoint_dir, "--outpath", str(tmp_path)])
    assert args.device is None and args.window == 1 and args.viewer == "none"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(args, _config(F2F))
