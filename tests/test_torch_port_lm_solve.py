"""The LM solve entry of the port (``ops.normal_eq.lm_solve``, one kernel
launch a solve on the card) on the CPU, where it runs its plain version,
against the JAX package's ``solve_pose`` (XLA normal equations at f32
matmul precision), on the same numpy inputs: realized iteration counts
EQUAL per sample, poses within 1e-5 tangent distance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_pose_tpu import se3 as jse3
from robust_pose_tpu.ops import geometry as jgeo
from robust_pose_tpu.solver.gauss_newton import SolverConfig as JSolverConfig
from robust_pose_tpu.solver.gauss_newton import solve_pose as j_solve_pose
from robust_pose_tpu_torch.ops import normal_eq
from robust_pose_tpu_torch.solver import gauss_newton
from robust_pose_tpu_torch.solver.gauss_newton import SolverConfig, solve_pose
from tests.test_torch_port_kernels import as_jax, as_port, solver_problem


def _jax_solve(p, h, w, cfg):
    with jax.default_matmul_precision("float32"):
        pose, _, n = jax.jit(lambda x: j_solve_pose(
            x, jgeo.create_img_coords(h, w), cfg))(as_jax(p))
    return np.asarray(pose), np.asarray(n)


def _port_solve(p, h, w, cfg):
    planes, kvec = normal_eq.pack_planes(as_port(p), h, w)
    return normal_eq.lm_solve(planes, kvec, torch.from_numpy(p["loss_weight"]),
                              h, w, cfg, flags=True)


def _tangent_distance(a, b):
    """Per-sample max |log(a^-1 b)|."""
    rel = jse3.mul(jse3.inv(jnp.asarray(a)), jnp.asarray(b))
    return np.abs(np.asarray(jse3.log(rel))).max(-1)


@pytest.mark.parametrize("case", ["early_exit", "to_the_cap", "b1_100"])
def test_lm_solve_matches_jax(case):
    """Counts equal; pose (quaternion renormalized as ``solve_pose`` does)
    within 1e-5; a sample stopped before the cap is done."""
    b, iters, early = {"early_exit": (3, 15, True), "to_the_cap": (3, 15, False),
                       "b1_100": (1, 100, True)}[case]
    h, w = 32, 48
    p = solver_problem(b=b, h=h, w=w, seed=7 if b == 3 else 11)
    jpose, jn = _jax_solve(p, h, w, JSolverConfig(iters=iters, early_exit=early))
    pose, n, done, failed = _port_solve(p, h, w, SolverConfig(iters=iters,
                                                              early_exit=early))
    np.testing.assert_array_equal(n.numpy(), jn)
    assert n.dtype == torch.int32
    pose = torch.cat([pose[:, :3], pose[:, 3:] / torch.linalg.norm(
        pose[:, 3:], dim=-1, keepdim=True)], dim=-1)
    assert _tangent_distance(pose.numpy(), jpose).max() < 1e-5
    assert bool(done[n < iters].all())


def _make_noise_free(p, i, seed=2):
    """Sample i's flow and 3D targets from a random small pose, no noise."""
    b, h, w, _ = p["flow"].shape
    rng = np.random.default_rng(seed)
    pose = np.asarray(jse3.exp(jnp.asarray(rng.normal(0, 0.02, 6), jnp.float32)))
    pcl1 = jnp.asarray(p["pcl1"][i].reshape(-1, 3))
    pp = np.asarray(jse3.act(jnp.asarray(pose)[None], pcl1))
    proj = pp @ p["intrinsics"][i].T
    coords = np.asarray(jgeo.create_img_coords(h, w))
    p["flow"][i] = (proj[:, :2] / proj[:, 2:] - coords[:, :2]).reshape(h, w, 2)
    p["pcl2"][i] = pp.reshape(h, w, 3)


def _edge_problem():
    """B = 3: sample 0 has every weight zero (H = 0: it ends when the
    damping saturates), sample 1 a NaN point (a NaN cost, never accepted),
    sample 2 a noise-free problem that converges early and is then frozen
    while the other two go on."""
    p = solver_problem(b=3, h=32, w=48, seed=5)
    _make_noise_free(p, 2)
    p["weights1"][0] = 0.0
    p["weights2"][0] = 0.0
    p["pcl1"][1, 3, 4] = np.nan
    return p


@pytest.mark.parametrize("early_exit", [True, False])
def test_lm_solve_edge_cases_match_jax(early_exit):
    """Zero weights and a NaN point end by damping saturation (17
    rejections from 1e-4 to 1e6: failed, pose the identity), like JAX; the
    clean sample stops early and stays frozen; counts equal per sample."""
    h, w, iters = 32, 48, 25
    p = _edge_problem()
    jpose, jn = _jax_solve(p, h, w, JSolverConfig(iters=iters, early_exit=early_exit))
    pose, n, done, failed = _port_solve(p, h, w, SolverConfig(
        iters=iters, early_exit=early_exit))
    np.testing.assert_array_equal(n.numpy(), jn)
    assert n[:2].tolist() == [17, 17] and bool(failed[:2].all())
    assert bool(done.all()) and not bool(failed[2])
    assert n[2] < 17
    ident = np.float32([0, 0, 0, 0, 0, 0, 1])
    np.testing.assert_array_equal(pose[:2].numpy(), np.stack([ident] * 2))
    np.testing.assert_array_equal(jpose[:2], np.stack([ident] * 2))
    assert _tangent_distance(pose[2:].numpy(), jpose[2:]).max() < 1e-5


def test_lm_solve_plain_takes_a_custom_build():
    """A ``build`` hook (the card's K3 kernel in chip_smoke.py) is called
    once a round and gives the default loop's result bit for bit."""
    h, w = 32, 48
    p = solver_problem(b=2, h=h, w=w, seed=3)
    planes, kvec = normal_eq.pack_planes(as_port(p), h, w)
    lw = torch.from_numpy(p["loss_weight"])
    calls = []

    def build(*args):
        calls.append(1)
        return normal_eq.normal_equations_plain(*args)

    cfg = SolverConfig(iters=12)
    ref = normal_eq.lm_solve_plain(planes, kvec, lw, h, w, cfg, flags=True)
    got = normal_eq.lm_solve_plain(planes, kvec, lw, h, w, cfg, build=build,
                                   flags=True)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert len(calls) == 1 + int(got[1].max())


def test_solve_pose_routes_cpu_tensors_to_the_plain_loop(monkeypatch):
    """On CPU tensors ``solve_pose`` runs ``lm_solve_plain`` (no kernel, no
    launch counted) and keeps its outputs and dtypes."""
    seen = []
    plain = normal_eq.lm_solve_plain

    def spy(*args, **kw):
        seen.append(args[0].device.type)
        return plain(*args, **kw)

    monkeypatch.setattr(normal_eq, "lm_solve_plain", spy)
    before = normal_eq.solve_launches
    p = solver_problem(b=2, h=32, w=48, seed=4)
    pose, tau, n = solve_pose(as_port(p), SolverConfig(iters=5))
    assert seen == ["cpu"] and normal_eq.solve_launches == before
    assert (pose.shape, tau.shape, n.shape) == ((2, 7), (2, 6), (2,))
    assert pose.dtype == tau.dtype == torch.float32 and n.dtype == torch.int32
    assert gauss_newton.lm_solve is normal_eq.lm_solve


@pytest.mark.parametrize("bad", ["f64", "shape", "lanes", "padding", "pixels",
                                 "kvec"])
def test_lm_solve_rejects_bad_planes(bad):
    """The wrapper checks ``pack_planes``'s layout on every device, as the
    kernel needs it: contiguous f32 (B, 12, S, 128), S * 128 a multiple of
    2048 holding H*W pixels; kvec (B, 4), loss_weight (B, 2)."""
    h, w = 32, 48
    p = solver_problem(b=2, h=h, w=w, seed=3)
    planes, kvec = normal_eq.pack_planes(as_port(p), h, w)
    lw = torch.from_numpy(p["loss_weight"])
    if bad == "f64":
        planes = planes.double()
    elif bad == "shape":
        planes = planes[:, :11]
    elif bad == "lanes":
        planes = planes.reshape(2, 12, -1, 64)
    elif bad == "padding":
        planes = planes[:, :, :8]
    elif bad == "pixels":
        h = 64
    else:
        kvec = kvec[:, :3]
    with pytest.raises(ValueError, match="lm_solve"):
        normal_eq.lm_solve(planes, kvec, lw, h, w, SolverConfig())


def test_solve6_lu_solves_and_pivots():
    """The kernel's LU on random SPD systems (within 1e-4 of LAPACK's,
    relative to max |x|), on a system whose first pivot is zero, and on a
    singular one (non-finite x: ``lm_propose`` zeroes the step and the
    trial is the pose, bit for bit)."""
    rng = np.random.default_rng(0)
    J = rng.normal(size=(64, 12, 6)).astype(np.float32)
    A = torch.from_numpy(J.transpose(0, 2, 1) @ J)
    b = torch.from_numpy(rng.normal(size=(64, 6)).astype(np.float32))
    x = normal_eq.solve6_lu(A, b)
    ref = torch.linalg.solve(A.double(), b.double())
    assert float(((x - ref).abs().amax(-1) / ref.abs().amax(-1)).max()) < 1e-4
    P = torch.eye(6)[[1, 0, 2, 3, 4, 5]][None] * 2.0    # a[0, 0] = 0
    np.testing.assert_allclose(normal_eq.solve6_lu(P, b[:1]).numpy(),
                               (b[:1] / 2.0)[:, [1, 0, 2, 3, 4, 5]].numpy())
    S = torch.ones(1, 6, 6)
    assert not bool(torch.isfinite(normal_eq.solve6_lu(S, b[:1])).all())
    pose = torch.tensor([[0.1, -0.2, 0.3, 0.0, 0.6, 0.0, 0.8]])
    trial, delta = normal_eq.lm_propose(-S, b[:1], torch.zeros(1), pose,
                                        solve=normal_eq.solve6_lu)
    assert torch.equal(delta, torch.zeros(1, 6)) and torch.equal(trial, pose)


def test_lm_solve_plain_in_f64_is_a_reference():
    """f64 planes run the whole loop in f64 (the card's reference for the
    f32 solve): the same optimum within 1e-5."""
    h, w = 32, 48
    p = solver_problem(b=2, h=h, w=w, seed=6)
    planes, kvec = normal_eq.pack_planes(as_port(p), h, w)
    lw = torch.from_numpy(p["loss_weight"])
    cfg = SolverConfig(iters=20)
    pose, n = normal_eq.lm_solve_plain(planes, kvec, lw, h, w, cfg)
    pose64, n64 = normal_eq.lm_solve_plain(planes.double(), kvec.double(),
                                           lw.double(), h, w, cfg)
    assert pose64.dtype == torch.float64 and n64.dtype == torch.int32
    assert _tangent_distance(pose.numpy(), pose64.float().numpy()).max() < 1e-5
