"""Nothing the benchmark runs loads JAX or the JAX package (compared by the
whole top-level name: ``repro_torch`` is the program), and the reference
imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
REPO = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imported(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not (_imported(path) & FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        assert "repro_torch" not in _imported(path), path


def test_loaded_modules_after_a_cpu_run():
    """Every harness module imported and a small cell driven on the CPU:
    no top-level name of JAX or the JAX package is loaded; the reference
    alone loads no module of the program."""
    code = """
import sys, copy
sys.path[:0] = [{repo!r}, {src!r}]
import torch
from fedgbf_bench.reference import fedgbf, draws
assert not any(m.split('.')[0] == 'repro_torch' for m in sys.modules)
from fedgbf_bench import bench, spec, counts, tracing, faults, calibrate, run
s = spec.load()
w = spec.cell(s, 'credit.train.local')
config = copy.deepcopy(spec.config_data(s, w['config']))
config['dataset']['n'] = 1500
config['model']['rounds'] = 2
env = bench.environment(s, w['name'], 1, torch.device('cpu'), config)
r = bench.execute(s, env, 0.01, False, 0.0, spec.limits(w['name']))
for m in s['end_to_end'] + s['per_layer']:
    spec.reader(m['name'])
print(sorted(run.forbidden_modules()), r['correct'])
"""
    out = subprocess.run(
        [sys.executable, "-c", code.format(repo=str(REPO),
                                           src=str(REPO / "src"))],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_run_refuses_without_a_card():
    """Without CUDA, run.py exits non-zero and prints no result."""
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload",
         "credit.train.local", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
