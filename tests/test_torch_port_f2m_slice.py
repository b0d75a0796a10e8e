"""The f2m slice end to end: the port's PoseNet f2m split and its
frame-to-model PoseEstimator against the JAX package's on the CPU, f32,
same weights and frames (those of tests/test_pose_estimator.py's f2m
window test). The estimator runs the first frame and four frames, once
per frame and once as one ``track_window``, with the production matching
threshold ``dist_thr`` 0.05, so that nearly every frame appends and the
pool's bucket grows twice (2 -> 4 -> 8 frames): the overflow redo runs in
both paths."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_pose_tpu.models.posenet import PoseNet as JPoseNet
from robust_pose_tpu.slam.pose_estimator import PoseEstimator as JPoseEstimator
from robust_pose_tpu_torch.models.posenet import PoseNet
from robust_pose_tpu_torch.slam.pose_estimator import PoseEstimator
from tests.test_torch_port_common import (  # noqa: F401 (fixture)
    jax_variables,
    random_state_dict,
    two_torch_threads,
)
from tests.test_torch_port_slice import (
    BASELINE,
    H,
    K,
    MODEL_CFG,
    W,
    _frames,
    _tangent_distance,
)

pytestmark = pytest.mark.usefixtures("two_torch_threads")

SLAM_CFG = {"frame2frame": False, "lbgfs_iters": 5, "conf_weighing": True,
            "depth_clipping": [1, 250], "dist_thr": 0.05, "average_pts": False,
            "map_capacity": 8 * H * W}


@pytest.fixture(scope="module")
def weights():
    sd = random_state_dict(PoseNet(MODEL_CFG, device="cpu"), seed=11)
    head = "flow.update.update_block.flow_head.conv2."
    sd[head + "weight"] = 0.1 * sd[head + "weight"]
    sd[head + "bias"] = torch.tensor([-0.1, 0.0])
    return sd


def _scene(est):
    st = est.scene.state
    a = np.asarray(st.active)
    return {"n_active": est.scene.n_active, "hi": int(np.asarray(st.hi)),
            "n_dropped": int(np.asarray(st.n_dropped)),
            "capacity": est.scene.cfg.capacity,
            "conf_sum": float(np.asarray(st.conf, np.float64)[a].sum()),
            "opts_sum": np.asarray(st.opts, np.float64)[a].sum(0),
            "active": a}


def _model_frame(mf):
    return {k: np.asarray(getattr(mf, k)) for k in ("img", "depth", "mask",
                                                     "confidence")}


@pytest.fixture(scope="module")
def runs(weights):
    frames = _frames(5)
    mask = np.ones((1, 1, H, W), bool)
    limgs = np.stack([f[0] for f in frames[1:]])
    rimgs = np.stack([f[1] for f in frames[1:]])
    out = {}
    with jax.default_matmul_precision("float32"):
        for name in ("jax", "port", "port_grouped"):
            # the port's "port" run names the on-the-fly lookup (K1's plain
            # version), the formulation this test has held against the JAX
            # estimator's default since the f2m slice was ported: with the
            # "xla" route, which "auto" now takes on the CPU in both
            # packages, the window's map is the same but for one surfel
            # match that f32 rounding flips at two threads (the live
            # confidences' sum then moves by 3.3e-5)
            ckpt_cfg = {"model": dict(MODEL_CFG, lookup={
                "jax": "auto", "port": "onthefly", "port_grouped": "grouped"}[name])}

            def make():
                if name == "jax":
                    return JPoseEstimator(SLAM_CFG, K, BASELINE, {
                        "params": jax_variables(weights), "config": ckpt_cfg}, (W, H))
                return PoseEstimator(SLAM_CFG, K, BASELINE, {
                    "state_dict": weights, "config": ckpt_cfg}, (W, H), device="cpu")

            o = out[name] = {}
            est = make()
            poses, succ, caps = [], [], []
            for limg, rimg in frames:
                pose, _, flow, confs = est(limg, rimg, mask)
                poses.append(np.asarray(pose))
                succ.append(bool(np.asarray(est.success)))
                caps.append(est.scene.cfg.capacity)
            o["frame"] = {"poses": np.stack(poses), "succ": np.array(succ),
                          "caps": caps, "scene": _scene(est),
                          "model_frame": _model_frame(est.get_last_frame()),
                          "flow": np.asarray(flow), "conf1": np.asarray(confs[0]),
                          "niter": np.asarray(est.last_solver_iters)}
            est = make()
            est(*frames[0], mask)
            p, s, d = est.track_window(limgs, rimgs, np.stack([mask] * 4),
                                       diagnostics=True)
            o["window"] = {"poses": np.asarray(p), "succ": np.asarray(s),
                           "scene": _scene(est),
                           "model_frame": _model_frame(est._model_frame),
                           "diag": {k: np.asarray(v, np.float32) for k, v in d.items()},
                           "niter": np.asarray(est.last_solver_iters),
                           "depth": np.asarray(est.get_frame().depth)}
    return out


@pytest.mark.parametrize("path", ["frame", "window"])
def test_f2m_poses_success_and_map_match(runs, path):
    """Poses within 1e-4 tangent distance (solver units), success flags
    equal, LM iterations within one (the early exit compares a step size
    with a threshold, and rounding can move one frame's exit by an
    iteration); the map's live count, high-water mark, drops,
    bucket and active set equal; sums of the live confidences rtol 1e-5 and
    of the live points rtol 1e-4."""
    j, p = runs["jax"][path], runs["port"][path]
    assert p["poses"].shape == j["poses"].shape
    np.testing.assert_array_equal(p["succ"], j["succ"])
    assert j["succ"].any(), "degenerate sequence: every frame failed"
    for i in range(len(p["poses"])):
        assert _tangent_distance(p["poses"][i], j["poses"][i]) <= 1e-4, i
    assert np.abs(p["niter"].reshape(-1) - j["niter"].reshape(-1)).max() <= 1
    sj, sp = j["scene"], p["scene"]
    for key in ("n_active", "hi", "n_dropped", "capacity"):
        assert sp[key] == sj[key], key
    np.testing.assert_array_equal(sp["active"], sj["active"])
    np.testing.assert_allclose(sp["conf_sum"], sj["conf_sum"], rtol=1e-5)
    np.testing.assert_allclose(sp["opts_sum"], sj["opts_sum"], rtol=1e-4)


def test_f2m_bucket_grew_in_both_paths(runs):
    """The sequence appends enough that the bucket grows (the overflow redo
    ran), identically per frame and windowed."""
    for name in ("jax", "port", "port_grouped"):
        caps = runs[name]["frame"]["caps"]
        assert caps[0] == 2 * H * W and caps[-1] > caps[0], caps
        assert (runs[name]["window"]["scene"]["capacity"]
                == runs[name]["frame"]["scene"]["capacity"])


@pytest.mark.parametrize("path", ["frame", "window"])
def test_f2m_model_frame_matches(runs, path):
    """The rendered model frame (per frame: the reference the last step
    tracked against; windowed: the carried next reference): mask equal,
    colours atol 1e-3, depth rtol 1e-4, confidence atol 1e-6 (per frame the
    frame carries the step's conf1: atol 1e-4)."""
    j, p = runs["jax"][path]["model_frame"], runs["port"][path]["model_frame"]
    np.testing.assert_array_equal(p["mask"], j["mask"])
    assert j["mask"].any()
    np.testing.assert_allclose(p["img"], j["img"], atol=1e-3)
    np.testing.assert_allclose(p["depth"], j["depth"], rtol=1e-4)
    np.testing.assert_allclose(p["confidence"], j["confidence"],
                               atol=1e-4 if path == "frame" else 1e-6)


@pytest.mark.parametrize("path", ["frame", "window"])
def test_f2m_grouped_lookup_tracks_like_the_default(runs, path):
    """The port's f2m with ``lookup: grouped`` (the plain K6/K7 on the CPU)
    against the JAX estimator's default lookup: the same correlation values
    summed in another order, so a surfel on a pixel or validity boundary
    may fall the other way. Poses within 1e-4 tangent distance, success
    flags equal, n_active within 0.5 %, the model frame's mask equal at
    >= 99.5 % of pixels (the card-vs-CPU tolerances of chip_smoke.py)."""
    j, p = runs["jax"][path], runs["port_grouped"][path]
    np.testing.assert_array_equal(p["succ"], j["succ"])
    for i in range(len(p["poses"])):
        assert _tangent_distance(p["poses"][i], j["poses"][i]) <= 1e-4, i
    nj = j["scene"]["n_active"]
    assert abs(p["scene"]["n_active"] - nj) <= 0.005 * nj
    flips = (p["model_frame"]["mask"] != j["model_frame"]["mask"]).mean()
    assert flips <= 0.005, flips


def test_f2m_step_outputs_and_window_diagnostics_match(runs):
    """The last per-frame step's flow atol 1e-3 px and conf1 atol 1e-4; the
    window's float16 diagnostics within those plus one float16 rounding
    step; the carried frame's depth rtol 1e-4."""
    j, p = runs["jax"], runs["port"]
    np.testing.assert_allclose(p["frame"]["flow"], j["frame"]["flow"], atol=1e-3)
    np.testing.assert_allclose(p["frame"]["conf1"], j["frame"]["conf1"], atol=1e-4)
    f16 = 2.0 ** -10
    dj, dp = j["window"]["diag"], p["window"]["diag"]
    for key, atol, rtol in (("flow", 1e-3, 0.0), ("conf1", 1e-4, 0.0),
                            ("conf2", 1e-4, 0.0), ("depth", 0.0, 1e-4)):
        assert dp[key].shape == dj[key].shape, key
        np.testing.assert_allclose(dp[key], dj[key], atol=atol, rtol=rtol + f16,
                                   err_msg=key)
    np.testing.assert_allclose(p["window"]["depth"], j["window"]["depth"], rtol=1e-4)


def test_posenet_f2m_split_matches_jax(weights):
    """PoseNet.f2m_precompute over two frames and f2m_track of the second
    against a reference image: every output of the precompute (features
    atol 1e-4, flow atol 1e-3 px, depth rtol 1e-4, mask equal) and of the
    step (pose 1e-4 tangent distance, flow atol 1e-3, conf atol 1e-4,
    equal LM iterations)."""
    cfg = dict(MODEL_CFG)
    rng = np.random.default_rng(3)
    frames = _frames(3)
    limgs = np.concatenate([f[0] for f in frames[1:]]).transpose(0, 2, 3, 1)
    rimgs = np.concatenate([f[1] for f in frames[1:]]).transpose(0, 2, 3, 1)
    masks = rng.uniform(size=(2, H, W, 1)) > 0.05
    ref_img = frames[0][0].transpose(0, 2, 3, 1)
    ref_depth = rng.uniform(0.3, 0.6, (1, H, W, 1)).astype(np.float32)
    ref_mask = rng.uniform(size=(1, H, W, 1)) > 0.2
    Kb = K.astype(np.float32)[None]
    bl = np.array([1.0], np.float32)
    port = PoseNet(cfg, device="cpu")
    port.load_state_dict(weights)
    jm, jv = JPoseNet(cfg), jax_variables(weights)
    t = torch.from_numpy
    with jax.default_matmul_precision("float32"):
        jpre = jm.apply(jv, *map(jnp.asarray, (limgs, rimgs, masks, bl)),
                        method=JPoseNet.f2m_precompute)
        sl = [x[1:] for x in jpre]
        jout = jm.apply(jv, jnp.asarray(ref_img), jnp.asarray(ref_depth),
                        jnp.asarray(ref_mask), jnp.zeros((1, H, W, 2)),
                        jnp.asarray(limgs[1:]), sl[5], jnp.asarray(Kb),
                        *sl[:5], method=JPoseNet.f2m_track)
    with torch.no_grad():
        ppre = port.f2m_precompute(t(limgs), t(rimgs), t(masks), t(bl))
        psl = [x[1:] for x in ppre]
        pout = port.f2m_track(t(ref_img), t(ref_depth), t(ref_mask),
                              torch.zeros(1, H, W, 2), t(limgs[1:]), psl[5],
                              t(Kb), *psl[:5])
    for i, (g, r) in enumerate(zip(ppre, jpre)):
        g, r = g.numpy(), np.asarray(r)
        if i == 5:
            np.testing.assert_array_equal(g, r)
        elif i == 4:
            np.testing.assert_allclose(g, r, rtol=1e-4)
        else:
            np.testing.assert_allclose(g, r, atol=1e-3 if i == 3 else 1e-4)
    assert _tangent_distance(pout.pose.numpy(), np.asarray(jout.pose)) <= 1e-4
    np.testing.assert_allclose(pout.flow.numpy(), np.asarray(jout.flow), atol=1e-3)
    for key in ("conf1", "conf2"):
        np.testing.assert_allclose(getattr(pout, key).numpy(),
                                   np.asarray(getattr(jout, key)), atol=1e-4)
    np.testing.assert_array_equal(pout.solver_iters.numpy(),
                                  np.asarray(jout.solver_iters))
