"""The port's scenario and evaluation CLIs on the CPU against the JAX
package's: ``scripts.benchmark_{scenarios,test}`` over one two-row CSV on
the PNG sequence and JAX checkpoint of ``tests/test_torch_port_cli.py``
(the same per-row folders, trajectories within 1e-4 tangent distance at
the 1/250 depth scale); ``evaluation.evaluate_ate_freiburg`` on each row
(the printed ATE and RPE within 0.05 mm and 0.01 deg);
``evaluation.inspect_results --source local`` over the synthetic run tree
of ``tests/test_viewers_and_eval_tail.py`` (the same printed tables);
``evaluation.trajectory_plots`` and ``TrajectoryAnalyzer`` (their figures,
and the printed ATE lines equal to JAX's).
"""
import contextlib
import io
import os
import re
import runpy
import sys

import numpy as np
import pytest
import torch

from robust_pose_tpu.utils.trajectory import read_freiburg, vec2mat
from tests.test_torch_port_cli import (  # noqa: F401
    ATE_TOL_MM,
    POSE_TOL,
    RPE_ROT_TOL_DEG,
    _tangent_distance,
    checkpoint_dir,
)
from tests.test_torch_port_data import write_png_sequence
from tests.test_viewers_and_eval_tail import _write_run

REPO = os.path.join(os.path.dirname(__file__), "..")
N_FRAMES = 8
ROWS = {"scenarios": "scenario,start,end\nbreathing,0,5\ntool,2,8\n",
        "test": "start,end\n0,5\n2,8\n"}
CSV = {"scenarios": "scenarios.csv", "test": "test_split.csv"}
# tests/test_torch_port_cli.py's F2F configuration, in the layout of
# configuration/infer_f2f.yaml
CONFIG = """slam:
  frame2frame: True
  checkpoint:
  dist_thr: 0.05
  depth_clipping:
    - 1
    - 250
  debug: False
  conf_weighing: False
  average_pts: False
  lbgfs_iters: 5

img_size:
  - 96
  - 64

rect_mode: conventional
"""


def _main_of(path, argv):
    """Run a JAX-side script as ``__main__`` with ``argv``; its stdout."""
    out = io.StringIO()
    old = sys.argv
    sys.argv = [path, *argv]
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = old
    return out.getvalue()


def _port(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench_seq")
    write_png_sequence(root, n=N_FRAMES, first=5)
    for kind, rows in ROWS.items():
        (root / CSV[kind]).write_text(rows)
    (root / "config.yaml").write_text(CONFIG)
    return root


@pytest.fixture(scope="module")
def runs(sequence, checkpoint_dir, tmp_path_factory):  # noqa: F811
    """Both scenario CLIs (``scenarios`` and ``test``), JAX and port, on
    the CPU: (outpath, stdout) by CLI and package."""
    from robust_pose_tpu_torch.scripts import benchmark_scenarios, benchmark_test

    port = {"scenarios": benchmark_scenarios.main, "test": benchmark_test.main}
    jax_path = {k: os.path.join(REPO, "scripts", f"benchmark_{k}.py")
                for k in port}
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    out = {}
    try:
        for kind in port:
            root = tmp_path_factory.mktemp(f"bench_{kind}")
            for pkg in ("jax", "port"):
                argv = [str(sequence), "--checkpoint", checkpoint_dir,
                        "--outpath", str(root / pkg), "--config",
                        str(sequence / "config.yaml"), "--device", "cpu"]
                text = (_main_of(jax_path[kind], argv) if pkg == "jax"
                        else _port(port[kind], argv))
                out[kind, pkg] = (root / pkg, text)
    finally:
        torch.set_num_threads(n)
    return out


@pytest.mark.parametrize("kind", ["scenarios", "test"])
def test_row_folders_and_trajectories_match_jax(runs, kind):
    (jroot, jtext), (proot, ptext) = runs[kind, "jax"], runs[kind, "port"]
    assert sorted(os.listdir(proot)) == sorted(os.listdir(jroot)) == ["0", "1"]
    heads = [ln for ln in ptext.splitlines() if "->" in ln]
    assert heads == [ln for ln in jtext.splitlines() if "->" in ln]
    assert heads == (["0 -> 5 : breathing", "2 -> 8 : tool"] if kind == "scenarios"
                     else ["0 -> 5", "2 -> 8"])
    for row, (start, stop) in enumerate(((0, 5), (2, 8))):
        pp, sp = read_freiburg(str(proot / str(row) / "trajectory.freiburg"),
                               ret_stamps=True)
        pj, sj = read_freiburg(str(jroot / str(row) / "trajectory.freiburg"),
                               ret_stamps=True)
        np.testing.assert_array_equal(sp, sj)
        assert len(pp) == 1 + stop - start
        assert np.isfinite(pp).all()
        for i in range(len(pp)):
            assert _tangent_distance(pp[i], pj[i]) <= POSE_TOL, (kind, row, i)
    assert ptext.count("finished") == jtext.count("finished") == 2


def _ate_lines(text):
    vals = {}
    for ln in text.splitlines():
        m = re.match(r"(\S+) (\S+) (mm|deg|pairs)$", ln.strip())
        if m:
            vals[m.group(1)] = float(m.group(2))
    return vals


@pytest.mark.parametrize("row", [0, 1])
def test_evaluate_ate_freiburg_matches_jax(runs, sequence, monkeypatch, row):
    """Each package's evaluator on its own CLI's trajectory of the row."""
    from robust_pose_tpu_torch.evaluation import evaluate_ate_freiburg

    gt = str(sequence / "groundtruth.txt")
    res = {}
    for pkg in ("jax", "port"):
        traj = str(runs["scenarios", pkg][0] / str(row) / "trajectory.freiburg")
        argv = [gt, traj, "--offset", "-4"]
        if pkg == "jax":
            text = _main_of(os.path.join(REPO, "evaluation",
                                         "evaluate_ate_freiburg.py"), argv)
        else:
            monkeypatch.setattr(sys, "argv", ["evaluate_ate_freiburg", *argv])
            text = _port(lambda _: evaluate_ate_freiburg.main(), None)
        res[pkg] = _ate_lines(text)
    j, p = res["jax"], res["port"]
    assert set(p) == set(j) and len(p) == 9
    assert p["compared_pose_pairs"] == j["compared_pose_pairs"] > 0
    for k, v in p.items():
        tol = RPE_ROT_TOL_DEG if k == "relative_pose_error.rot" else ATE_TOL_MM
        assert abs(v - j[k]) <= tol, k


@pytest.fixture()
def run_tree(tmp_path):
    """``tests/test_viewers_and_eval_tail.py``'s results tree: two methods,
    two datasets, one run each, ground truth beside the runs."""
    root = tmp_path / "results"
    for method in ("ours", "orbslam2"):
        for ds, seed in (("seq_01", 1), ("seq_02", 2)):
            run = root / method / ds / "run0"
            _write_run(str(run), seed=seed)
            gt = _write_run(str(run.parent), seed=seed + 10)
            os.rename(gt, str(run.parent / "groundtruth.txt"))
    return root


@pytest.mark.parametrize("mode", ["test", "scenario"])
def test_inspect_results_prints_the_jax_tables(run_tree, tmp_path, monkeypatch,
                                                mode):
    from robust_pose_tpu_torch.evaluation import inspect_results

    argv = [str(run_tree), "--methods", "ours", "orbslam2", "--source", "local",
            "--group-mode", mode]
    text = {}
    for pkg in ("jax", "port"):
        cwd = tmp_path / pkg
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        text[pkg] = (_main_of(os.path.join(REPO, "evaluation", "inspect_results.py"),
                              argv) if pkg == "jax"
                     else _port(inspect_results.main, argv))
        assert (cwd / "project.csv").is_file()
    assert text["port"] == text["jax"]
    assert text["port"].count("macro average") == (6 if mode == "test" else 2)
    assert (tmp_path / "port" / "project.csv").read_text().splitlines()[0] == \
        (tmp_path / "jax" / "project.csv").read_text().splitlines()[0]


def test_trajectory_plots_matches_jax(tmp_path, monkeypatch):
    from robust_pose_tpu_torch.evaluation import trajectory_plots

    base = tmp_path / "dataset_x" / "keyframe_1"
    _write_run(str(base / "data" / "ours"))
    _write_run(str(base / "data" / "orbslam2"), seed=5)
    gt = _write_run(str(base), seed=3)
    os.rename(gt, str(base / "groundtruth.txt"))
    monkeypatch.setenv("MPLBACKEND", "Agg")
    text = {}
    for pkg, prealign in (("jax", False), ("port", False), ("jax", True),
                          ("port", True)):
        out = tmp_path / f"{pkg}{prealign}.png"
        argv = [str(base), "--methods", "ours", "orbslam2", "ground-truth",
                "--out", str(out)] + (["--prealign"] if prealign else [])
        got = (_main_of(os.path.join(REPO, "evaluation", "trajectory_plots.py"),
                        argv) if pkg == "jax"
               else _port(trajectory_plots.main, argv))
        assert out.is_file() and out.stat().st_size > 0
        text[pkg, prealign] = [ln for ln in got.splitlines()
                               if not ln.startswith("saved ")]
    for prealign in (False, True):
        assert text["port", prealign] == text["jax", prealign]
        assert len(text["port", prealign]) == 8


@pytest.mark.parametrize("plot_3d", [False, True])
def test_trajectory_analyzer_writes_its_figure(tmp_path, plot_3d):
    from robust_pose_tpu_torch.utils.trajectory_analyzer import TrajectoryAnalyzer

    poses = vec2mat(read_freiburg(_write_run(str(tmp_path))))
    ta = TrajectoryAnalyzer(plot_3d=plot_3d, title="t")
    ta.add_pose_trajectory(np.asarray(poses), label="ours")
    ta.add_pose_trajectory(np.asarray(poses)[::-1], label="reversed",
                           color="k", linestyle="dashed")
    ta.legend()
    out = tmp_path / f"plot{plot_3d}.png"
    ta.write_file(str(out))
    assert out.stat().st_size > 0 and ta.label == ["ours", "reversed"]
