"""The run loads neither JAX nor the JAX package; the reference imports
nothing of the program. Top-level module names are compared whole:
``robust_pose_tpu_torch`` is not ``robust_pose_tpu``."""
import ast
import json
import subprocess
import sys
from pathlib import Path

from port_bench import run

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "port_bench"


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_forbidden_names_compare_whole():
    assert run.forbidden_modules(["robust_pose_tpu_torch.models", "jaxtyping",
                                  "flaxen", "torch"]) == []
    assert run.forbidden_modules(["robust_pose_tpu.models.raft", "jax",
                                  "jaxlib.xla_client", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "robust_pose_tpu"]


def test_reference_imports_nothing_of_the_program():
    for path in sorted((PKG / "reference").glob("*.py")):
        tops = set(_imports(path))
        assert not tops & {"robust_pose_tpu_torch", "robust_pose_tpu",
                           "jax", "jaxlib", "flax"}, path


def test_harness_imports_no_jax():
    for path in sorted(PKG.rglob("*.py")):
        assert not set(_imports(path)) & {"robust_pose_tpu", "jax", "jaxlib",
                                           "flax"}, path


def test_a_run_loads_no_jax():
    """A whole small run on the CPU in a fresh process, then the loaded
    modules' top-level names."""
    code = (
        "import json, sys, torch\n"
        "from pathlib import Path\n"
        "from port_bench import run\n"
        "from port_bench.tests.conftest import SMALL\n"
        "torch.set_num_threads(2)\n"
        "r = run.run_cell('f2f.stream8', 7, 0.5, True, torch.device('cpu'),\n"
        "                 Path('.'), SMALL['f2f'])\n"
        "print(json.dumps({'bad': run.forbidden_modules(),\n"
        "                  'port': 'robust_pose_tpu_torch' in sys.modules,\n"
        "                  'attempted': r['attempted']}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=600, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"bad": [], "port": True, "attempted": res["attempted"]}
    assert res["attempted"] >= 1


def test_main_refuses_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(ROOT)
    assert run.main(["--workload", "f2f.stream8", "--seed", "1",
                     "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err
