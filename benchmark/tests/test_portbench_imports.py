"""What the benchmark loads: never JAX or the JAX package, and the
reference nothing of the program. Top-level module names are compared
whole: the program's own name begins with the JAX package's."""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

from conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "spmv_topk_tpu"}
BENCH = os.path.join(REPO, "benchmark")

LOAD_ALL = r"""
import glob, importlib.util, json, os, sys
root = sys.argv[1]
spec = importlib.util.spec_from_file_location("bench_run",
                                              os.path.join(root, "benchmark", "run.py"))
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)                      # not as __main__: no run
import benchmark.harness, benchmark.readings, benchmark.reference.exact_topk
import spmv_topk_tpu_torch, spmv_topk_tpu_torch.formats.coo
for path in glob.glob(os.path.join(root, "benchmark", "metrics", "*.py")):
    s = importlib.util.spec_from_file_location("m_" + os.path.basename(path)[:-3], path)
    s.loader.exec_module(importlib.util.module_from_spec(s))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

LOAD_REFERENCE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import benchmark.reference.exact_topk
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_levels(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code, REPO], cwd="/",
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


def test_run_and_all_it_loads_leave_jax_out():
    names = _top_levels(LOAD_ALL)
    assert "spmv_topk_tpu_torch" in names and "torch" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = _top_levels(LOAD_REFERENCE)
    assert "torch" in names
    assert not names & (FORBIDDEN | {"spmv_topk_tpu_torch"})


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(
    glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True)),
    ids=lambda p: os.path.relpath(p, BENCH))
def test_no_source_names_jax(path):
    names = set(_imports(path))
    assert not names & FORBIDDEN
    if os.sep + "reference" + os.sep in path:
        assert "spmv_topk_tpu_torch" not in names
