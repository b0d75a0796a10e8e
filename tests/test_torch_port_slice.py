"""The f2f slice end to end: the port's PoseEstimator against the JAX
package's on the CPU, f32, same weights and frames: the first frame, then
two 2-frame ``track_window`` calls, so the cross-window carry (frame state
and encoder cache) is exercised, then one per-frame step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_pose_tpu import se3 as jse3
from robust_pose_tpu.slam.pose_estimator import PoseEstimator as JPoseEstimator
from robust_pose_tpu_torch.models.posenet import PoseNet
from robust_pose_tpu_torch.slam.pose_estimator import PoseEstimator
from tests.test_torch_port_common import jax_variables, random_state_dict

H, W = 64, 96
MODEL_CFG = {"image_shape": (H, W), "iters": 2, "lbgfs_iters": 5,
             "use_weights": True, "mixed_precision": False, "unet_levels": 1}
SLAM_CFG = {"frame2frame": True, "lbgfs_iters": 5, "conf_weighing": True,
            "depth_clipping": [1, 250], "dist_thr": 0.05, "average_pts": False}
K = np.array([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1.0]])
BASELINE = 250.0   # normalized stereo baseline 1.0: valid iff flow_x <= -1 px


def _frames(n):
    """Shifted crops of one blurred random texture (NCHW, [0, 255])."""
    import cv2

    rng = np.random.default_rng(0)
    base = cv2.GaussianBlur(
        rng.integers(0, 255, (H, W + 32, 3)).astype(np.float32), (0, 0), 2)
    return [(base[:, 2 * i:2 * i + W].transpose(2, 0, 1)[None],
             base[:, 2 * i + 3:2 * i + 3 + W].transpose(2, 0, 1)[None])
            for i in range(n)]


@pytest.fixture(scope="module")
def runs():
    sd = random_state_dict(PoseNet(MODEL_CFG, device="cpu"), seed=11)
    # damp and bias the flow head so the untrained net yields ~-1.5 px
    # flows: valid disparity at most pixels and small, successful poses
    head = "flow.update.update_block.flow_head.conv2."
    sd[head + "weight"] = 0.1 * sd[head + "weight"]
    sd[head + "bias"] = torch.tensor([-0.1, 0.0])
    ckpt_cfg = {"model": MODEL_CFG}
    jest = JPoseEstimator(SLAM_CFG, K, BASELINE,
                          {"params": jax_variables(sd), "config": ckpt_cfg},
                          (W, H))
    pest = PoseEstimator(SLAM_CFG, K, BASELINE,
                         {"state_dict": sd, "config": ckpt_cfg}, (W, H),
                         device="cpu")
    frames = _frames(6)
    mask = np.ones((1, 1, H, W), bool)
    out = {"jax": {}, "port": {}}
    with jax.default_matmul_precision("float32"):
        for name, est in (("jax", jest), ("port", pest)):
            o = out[name]
            est(*frames[0], mask)
            o["first_mask"] = np.asarray(est.frame.mask)
            o["first_depth"] = np.asarray(est.frame.depth)
            poses, succ, diags = [], [], []
            for lo in (1, 3):
                limgs = np.stack([f[0] for f in frames[lo:lo + 2]])
                rimgs = np.stack([f[1] for f in frames[lo:lo + 2]])
                p, s, d = est.track_window(limgs, rimgs, np.stack([mask] * 2),
                                           diagnostics=True)
                poses.append(np.asarray(p))
                succ.append(np.asarray(s))
                diags.append({k: np.asarray(v, np.float32) for k, v in d.items()})
            o["poses"] = np.concatenate(poses)
            o["succ"] = np.concatenate(succ)
            o["diag"] = diags
            o["niter"] = np.asarray(est.last_solver_iters)
            o["carry_mask"] = np.asarray(est.frame.mask)
            o["carry_depth"] = np.asarray(est.frame.depth)
            pose, _, flow, (conf1, conf2) = est(*frames[5], mask)
            o["step"] = {"pose": np.asarray(pose), "flow": np.asarray(flow),
                         "conf1": np.asarray(conf1), "conf2": np.asarray(conf2),
                         "depth": np.asarray(est.frame.depth)}
    return out


def _tangent_distance(a, b):
    """max |log(a^-1 b)| with translations in the solver's normalized depth
    units (world units / 250, the depth-clipping scale)."""
    a, b = (jse3.scale(jnp.asarray(x), 1.0 / 250.0) for x in (a, b))
    rel = jse3.mul(jse3.inv(a), b)
    return float(np.abs(np.asarray(jse3.log(rel))).max())


def test_window_poses_and_success_match(runs):
    """Poses within 1e-4 tangent distance; success flags equal."""
    j, p = runs["jax"], runs["port"]
    assert p["poses"].shape == (4, 1, 7)
    np.testing.assert_array_equal(p["succ"], j["succ"])
    assert j["succ"].any(), "degenerate sequence: every frame failed"
    for i in range(4):
        assert _tangent_distance(p["poses"][i], j["poses"][i]) <= 1e-4, i
    np.testing.assert_array_equal(p["niter"], j["niter"])


def test_masks_and_carried_frame_match(runs):
    """Stereo-valid masks bit-exact; carried depth rtol 1e-4."""
    j, p = runs["jax"], runs["port"]
    np.testing.assert_array_equal(p["first_mask"], j["first_mask"])
    np.testing.assert_array_equal(p["carry_mask"], j["carry_mask"])
    for key in ("first_depth", "carry_depth"):
        # invalid depth holds the placeholder 1.0 / scale = 250 (f32)
        valid = np.abs(j[key] - 250.0) > 1e-3
        assert valid.any() and not valid.all()
        np.testing.assert_array_equal(np.abs(p[key] - 250.0) > 1e-3, valid)
        np.testing.assert_allclose(p[key], j[key], rtol=1e-4)


def test_window_diagnostics_match(runs):
    """Diagnostics are float16 in both packages: flow atol 1e-3 px, conf
    atol 1e-4 and depth rtol 1e-4, each widened by one float16 rounding
    step of the value (2^-10 relative) for the cast both sides make."""
    f16 = 2.0 ** -10
    for dj, dp in zip(runs["jax"]["diag"], runs["port"]["diag"]):
        for key, atol, rtol in (("flow", 1e-3, 0.0), ("conf1", 1e-4, 0.0),
                                ("conf2", 1e-4, 0.0), ("depth", 0.0, 1e-4)):
            assert dp[key].shape == dj[key].shape, key
            np.testing.assert_allclose(dp[key], dj[key], atol=atol,
                                       rtol=rtol + f16, err_msg=key)


def test_per_frame_step_matches(runs):
    """The per-frame f2f step after the windows (f32 outputs): pose 1e-4
    tangent distance, flow atol 1e-3 px, conf atol 1e-4, depth rtol 1e-4."""
    j, p = runs["jax"]["step"], runs["port"]["step"]
    assert _tangent_distance(p["pose"], j["pose"]) <= 1e-4
    np.testing.assert_allclose(p["flow"], j["flow"], atol=1e-3)
    np.testing.assert_allclose(p["conf1"], j["conf1"], atol=1e-4)
    np.testing.assert_allclose(p["conf2"], j["conf2"], atol=1e-4)
    np.testing.assert_allclose(p["depth"], j["depth"], rtol=1e-4)
