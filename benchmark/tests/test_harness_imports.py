"""Nothing under benchmark/ imports JAX, jaxlib, flax or the JAX package,
by the top-level name of each import (the part before the first dot) as a
whole string: stylegan_v_tpu_torch, the program, begins with the JAX
package's name and is allowed. The run's own check at the end of a run
uses the same rule on sys.modules."""
import ast
import os
import subprocess
import sys

from helpers import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "stylegan_v_tpu"}


def _imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_source_under_the_benchmark_imports_jax():
    found = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, "benchmark")):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                found += [(path, t) for t in _imported_tops(path) if t in FORBIDDEN]
    assert not found


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(ROOT, "benchmark", "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            assert "stylegan_v_tpu_torch" not in set(_imported_tops(os.path.join(ref, f)))


def test_forbidden_modules_compares_whole_top_level_names():
    from benchmark.lib import env
    saved = dict(sys.modules)
    try:
        sys.modules["stylegan_v_tpu_torch_fake"] = object()
        sys.modules["jaxtyping"] = object()
        assert env.forbidden_modules() == sorted(m for m in saved
                                                 if m.split(".")[0] in FORBIDDEN)
        sys.modules["jax.numpy"] = object()
        assert "jax.numpy" in env.forbidden_modules()
    finally:
        for k in ("stylegan_v_tpu_torch_fake", "jaxtyping", "jax.numpy"):
            if k not in saved:
                sys.modules.pop(k, None)


def test_a_run_loads_no_jax():
    code = ("import sys, torch; sys.path.insert(0, 'benchmark/tests'); import helpers;"
            "helpers.cpu_run('sgv_tiny.synth16f');"
            "from benchmark.lib.env import forbidden_modules; print(forbidden_modules())")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
