"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Names compare whole, by the part
before the first dot: the port's name begins with the JAX package's."""

import ast
import glob
import os
import subprocess
import sys

from portbench import spec

JAX = {"jax", "jaxlib", "flax", "vectorsearch_tpu"}
LOCAL = {"portbench", "vectorsearch_torch"}


def _file_of(module: str):
    base = os.path.join(spec.ROOT, *module.split("."))
    for path in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.exists(path):
            return path
    return None


def _package_of(path: str) -> str:
    rel = os.path.relpath(path, spec.ROOT)[:-3].replace(os.sep, ".")
    return rel[: -len(".__init__")] if rel.endswith(".__init__") else rel.rsplit(".", 1)[0]


def _imports(path: str):
    """Every module an import statement of the file names, at any depth
    (imports inside functions included)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if node.level:
                pkg = _package_of(path).split(".")
                pkg = pkg[: len(pkg) - node.level + 1]
                mod = ".".join(pkg + ([mod] if mod else []))
            out.append(mod)
            out += [f"{mod}.{a.name}" for a in node.names]
    return out


def closure(paths):
    """Top-level names of every module reached from the files, following the
    repository's own modules through every import."""
    seen, names, todo = set(), set(), list(paths)
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for mod in _imports(path):
            top = mod.split(".")[0]
            names.add(top)
            if top in LOCAL:
                f = _file_of(mod)
                if f:
                    todo.append(f)
    return names, seen


def test_the_run_imports_nothing_of_jax():
    roots = [os.path.join(spec.PKG, "run.py")] + glob.glob(
        os.path.join(spec.PKG, "metrics", "*.py"))
    names, files = closure(roots)
    assert not names & JAX, names & JAX
    # the walk reached the harness, the reference and the port itself
    assert any(f.endswith(os.path.join("portbench", "harness.py")) for f in files)
    assert any(f.endswith(os.path.join("reference", "knn.py")) for f in files)
    assert any(f.endswith(os.path.join("core", "index.py")) for f in files)


def test_the_reference_imports_nothing_of_the_program():
    names, _files = closure(glob.glob(os.path.join(spec.PKG, "reference", "*.py")))
    assert not names & (JAX | {"vectorsearch_torch"}), names
    assert {"numpy", "torch"} <= names


_PROBE = r"""
import sys, time
from portbench.tests.conftest import run_tiny, tiny
from portbench import harness
for name in ("sift1m.batch512", "deep10m.churn"):
    assert run_tiny(tiny(name), seconds=0.5)["correct"]
print("LOADED", harness.forbidden_modules())
"""


def test_a_run_loads_nothing_of_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = spec.ROOT
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=spec.ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout, out.stdout
