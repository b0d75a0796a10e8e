"""The port's viewers and plots (``robust_pose_tpu_torch.viewer``,
``utils/plotting``) and the inference CLI's ``--viewer`` on the CPU against
the JAX package: ``flow_to_image`` bit for bit; the warps of
``utils/plotting`` (warp field within 1e-5 or two f32 steps of its ~100 px
values, nearest samples bit for bit),
``plot_res``' figure; ``Viewer2D``'s PNGs; ``viewer3d`` and
``view_renderer`` against the open3d stub of
``tests/test_viewers_and_eval_tail.py``; and both CLIs with ``--viewer 2d``
per frame and with ``--window 4`` on the checkpoint and PNG sequence of
``tests/test_torch_port_cli.py``: a spy on each side's ``Viewer2D.__call__``
records what the viewer gets.

Tolerances for the viewer's arrays: images equal; per frame (f32 maps)
flow within 1e-3 px, depth and confidences within 1e-4; with ``--window``
the maps ride as f16 on both sides, so each may differ by one f16 step
of its value (relative 2^-10) besides.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_pose_tpu.slam.surfel_map import SurfelConfig, surfel_create
from robust_pose_tpu.utils import plotting as jplot
from robust_pose_tpu.viewer import viewer2d as jviewer2d
from robust_pose_tpu.viewer import viewer3d as jviewer3d
from robust_pose_tpu_torch.utils import plotting as pplot
from robust_pose_tpu_torch.utils.convert import surfel_state_from_jax
from robust_pose_tpu_torch.viewer import view_renderer as prenderer
from robust_pose_tpu_torch.viewer import viewer2d as pviewer2d
from robust_pose_tpu_torch.viewer import viewer3d as pviewer3d
from tests.test_torch_port_cli import F2F, _args, _config, checkpoint_dir  # noqa: F401
from tests.test_torch_port_data import write_png_sequence
from tests.test_viewers_and_eval_tail import _make_stub

H, W = 64, 96
FLOW_TOL_PX = 1e-3
MAP_TOL = 1e-4
F16_REL = 2.0 ** -10


def rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("scale", [0.0, 1e-6, 1.0, 37.5])
def test_flow_to_image_matches_jax_bit_for_bit(scale):
    flow = (scale * rng(1).normal(size=(H, W, 2))).astype(np.float32)
    flow[3, 4] = [0.0, 0.0]
    got = pviewer2d.flow_to_image(flow)
    assert got.dtype == np.uint8 and got.shape == (H, W, 3)
    np.testing.assert_array_equal(got, jviewer2d.flow_to_image(flow))


def test_flow_to_image_takes_tensors_through_to_host():
    flow = rng(2).normal(size=(H, W, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        pviewer2d.flow_to_image(pviewer2d.to_host(torch.from_numpy(flow).half())),
        jviewer2d.flow_to_image(flow.astype(np.float16).astype(np.float32)))


def _warp_inputs(seed):
    r = rng(seed)
    img = r.uniform(0.0, 255.0, (H, W, 3)).astype(np.float32)
    depth = r.uniform(20.0, 40.0, (H, W, 1)).astype(np.float32)
    rot = np.array([0.01, -0.02, 0.015])
    pose = np.concatenate([[0.3, -0.2, 0.5], np.sin(rot / 2),
                           [np.cos(np.linalg.norm(rot) / 2)]]).astype(np.float32)
    pose[3:] /= np.linalg.norm(pose[3:])
    K = np.array([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1.0]], np.float32)
    flow = (4.0 * r.normal(size=(H, W, 2))).astype(np.float32)
    return img, depth, pose, K, flow


@pytest.mark.parametrize("seed", [3, 4])
def test_warp_frame_matches_jax(seed):
    img, depth, pose, K, _ = _warp_inputs(seed)
    coords_p = pplot.create_img_coords(H, W)
    wf_p = pplot._get_warpfield(torch.from_numpy(depth)[None],
                                torch.from_numpy(pose)[None],
                                torch.from_numpy(K)[None], coords_p)
    wf_j = jplot._get_warpfield(jnp.asarray(depth)[None], jnp.asarray(pose)[None],
                                jnp.asarray(K)[None], jplot.create_img_coords(H, W))
    # pixel coordinates up to ~100: 1e-5, or two f32 steps of the value
    np.testing.assert_allclose(wf_p.numpy(), np.asarray(wf_j), atol=1e-5, rtol=2e-7)
    got = pplot.warp_frame(img, depth, pose, K)
    assert got.dtype == np.uint8 and got.shape == (H, W, 3)
    np.testing.assert_array_equal(got, jplot.warp_frame(img, depth, pose, K))
    # tensors in, the same image out
    np.testing.assert_array_equal(
        pplot.warp_frame(*(torch.from_numpy(a) for a in (img, depth, pose, K))), got)


@pytest.mark.parametrize("seed", [5, 6])
def test_warp_frame_flow_matches_jax_bit_for_bit(seed):
    img, _, _, _, flow = _warp_inputs(seed)
    got = pplot.warp_frame_flow(img, flow)
    assert got.dtype == np.uint8 and got.shape == (H, W, 3)
    np.testing.assert_array_equal(got, jplot.warp_frame_flow(img, flow))
    np.testing.assert_array_equal(
        pplot.warp_frame_flow(torch.from_numpy(img), torch.from_numpy(flow)), got)


def test_plot_res_draws_the_grid(tmp_path):
    import matplotlib.pyplot as plt

    batch = [_warp_inputs(s) for s in (7, 8)]
    img1, depth, pose, K, flow = (np.stack(x) for x in zip(*batch))
    img2 = np.roll(img1, 2, axis=2)
    conf = rng(9).uniform(0, 1, (2, H, W, 1)).astype(np.float32)
    args = (img1, img2, flow, depth, pose, conf, 1 - conf, K)
    fig, axs = pplot.plot_res(*(torch.from_numpy(a) for a in args))
    assert axs.shape == (2, 7)
    for r in range(2):
        for c in range(7):
            shown = axs[r, c].get_images()[0].get_array()
            assert shown.shape == (H, W, 3)
    # the same panels as the JAX grid
    _, jaxs = jplot.plot_res(*args)
    for r in range(2):
        for c in range(7):
            np.testing.assert_array_equal(axs[r, c].get_images()[0].get_array(),
                                          jaxs[r, c].get_images()[0].get_array())
    out = tmp_path / "res.png"
    fig.savefig(out)
    plt.close("all")
    assert out.stat().st_size > 0


def test_viewer2d_writes_its_pngs(tmp_path):
    from types import SimpleNamespace

    v = pviewer2d.Viewer2D(outpath=str(tmp_path), blocking=False)
    img, depth, _, _, flow = _warp_inputs(10)
    frame = SimpleNamespace(img=torch.from_numpy(img)[None],
                            depth=torch.from_numpy(depth)[None].half())
    conf = torch.rand(1, H, W, 1, generator=torch.Generator().manual_seed(0))
    for idx in (1, 7):
        v(frame, (conf, 1 - conf), torch.from_numpy(flow)[None], idx)
    for idx in (1, 7):
        png = tmp_path / "imgs" / f"vis_{idx:06d}.png"
        assert png.is_file() and png.stat().st_size > 0


@pytest.fixture()
def stub_open3d(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "open3d", _make_stub())


def _surfel_states():
    """A JAX surfel state with half its surfels stable, and the port's."""
    h, w = 16, 20
    img = 255.0 * jax.random.uniform(jax.random.PRNGKey(0), (1, h, w, 3))
    from robust_pose_tpu.slam.frame import make_frame

    frame = make_frame(img, depth=jnp.full((1, h, w, 1), 50.0))
    kmat = jnp.array([[20.0, 0, w / 2], [0, 20.0, h / 2], [0, 0, 1.0]])
    st = surfel_create(frame, kmat, SurfelConfig(capacity=2 * h * w,
                                                 img_shape=(h, w)))
    conf = np.asarray(st.conf).copy()
    conf[::2] = 1.5
    st = st._replace(conf=jnp.asarray(conf))
    return st, surfel_state_from_jax(st)


@pytest.mark.parametrize("stable", [True, False])
def test_surfels_to_open3d_matches_jax(stub_open3d, stable):
    jst, pst = _surfel_states()
    got = pviewer3d.surfels_to_open3d(pst, depth_scale=2.0, stable=stable)
    want = jviewer3d.surfels_to_open3d(jst, depth_scale=2.0, stable=stable)
    assert len(got.points) > 0
    np.testing.assert_allclose(got.points, want.points, rtol=0, atol=0)
    np.testing.assert_allclose(got.colors, want.colors, rtol=1e-7, atol=0)


def test_viewer3d_follows_the_pose(stub_open3d):
    _, pst = _surfel_states()
    v = pviewer3d.Viewer3D((32, 40), blocking=False)
    pcd = pviewer3d.surfels_to_open3d(pst, stable=False)
    pose = np.array([1.0, 2.0, 3.0, 0, 0, 0, 1.0])
    v(pose, pcd=pcd)
    assert pcd in v.viewer.geoms
    j = jviewer3d.Viewer3D((32, 40), blocking=False)
    j(pose, pcd=pcd)
    np.testing.assert_array_equal(v.ref_view.extrinsic, j.ref_view.extrinsic)
    assert (v.viewer.width, v.viewer.height) == (40, 32)


def test_view_renderer_writes_video(stub_open3d, tmp_path):
    _, pst = _surfel_states()
    r = prenderer.ViewRenderer((32, 40), str(tmp_path))
    pcd = pviewer3d.surfels_to_open3d(pst, stable=False)
    pose = np.array([0.0, 0, 0, 0, 0, 0, 1.0])
    for _ in range(3):
        assert np.asarray(r(pose, pcd)).shape == (31, 40, 3)
    r.vid_writer.release()
    vid = tmp_path / "vis.mp4"
    assert vid.is_file() and vid.stat().st_size > 0


# --- the CLI's --viewer 2d -------------------------------------------------------

def _spy(calls, host):
    def record(self, frame, weights, flow, idx=0):
        calls.append({"img": host(frame.img), "depth": host(frame.depth),
                      "conf1": host(weights[0]), "conf2": host(weights[1]),
                      "flow": host(flow), "idx": idx})
    return record


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    return write_png_sequence(tmp_path_factory.mktemp("viewer_png"), first=5)


@pytest.mark.parametrize("window", [1, 4], ids=["per_frame", "window4"])
def test_cli_viewer2d_gets_the_jax_arrays(png_dir, checkpoint_dir, tmp_path,  # noqa: F811
                                          monkeypatch, window):
    from robust_pose_tpu_torch.scripts.infer_trajectory import main as port_main
    from scripts.infer_trajectory import main as jax_main

    calls = {"jax": [], "port": []}
    monkeypatch.setattr(jviewer2d.Viewer2D, "__call__",
                        _spy(calls["jax"],
                             lambda x: np.asarray(x, np.float32)))
    monkeypatch.setattr(pviewer2d.Viewer2D, "__call__",
                        _spy(calls["port"],
                             lambda x: pviewer2d.to_host(x).astype(np.float32)))
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        for pkg, main in (("jax", jax_main), ("port", port_main)):
            args = _args(png_dir, checkpoint_dir, str(tmp_path / pkg), window,
                         False, viewer="2d", device="cpu")
            main(args, _config(F2F))
    finally:
        torch.set_num_threads(n)
    jc, pc = calls["jax"], calls["port"]
    assert len(pc) == len(jc) == 4                  # every frame but the first
    assert os.path.isdir(tmp_path / "port" / "imgs")
    for j, p in zip(jc, pc):
        assert p["idx"] == j["idx"]
        assert p["img"].shape == (1, H, W, 3) and p["flow"].shape == (1, H, W, 2)
        for k in ("depth", "conf1", "conf2"):
            assert p[k].shape == (1, H, W, 1), k
        np.testing.assert_array_equal(p["img"], j["img"])
        rtol = 0.0 if window == 1 else F16_REL
        np.testing.assert_allclose(p["flow"], j["flow"], atol=FLOW_TOL_PX, rtol=rtol)
        for k in ("depth", "conf1", "conf2"):
            np.testing.assert_allclose(p[k], j[k], atol=MAP_TOL, rtol=rtol)
