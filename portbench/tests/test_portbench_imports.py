"""The benchmark loads neither JAX nor the JAX package, and its reference
imports nothing of the program under test."""

import ast
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def test_no_module_loads_jax_or_the_jax_package():
    code = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "swipe_tpu"):
    sys.modules[name] = None
import portbench
names = [m.name for m in pkgutil.walk_packages(portbench.__path__,
                                               "portbench.")
         if ".tests" not in m.name]
for name in names:
    importlib.import_module(name)
import swipe_tpu_torch.pipeline, swipe_tpu_torch.report
for kind in ("metrics", "generators", "modes"):
    for f in sorted(os.listdir(os.path.join(portbench.__path__[0], kind))):
        if f.endswith(".py"):
            portbench.workload.load_module(kind, f[:-3])
bad = sorted({n.split(".")[0] for n, m in sys.modules.items()
              if m is not None} & {"jax", "jaxlib", "flax", "swipe_tpu"})
assert not bad, bad
print(len(names))
"""
    r = subprocess.run([sys.executable, "-c", "import os\n" + code],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=120, env={**os.environ, "PYTHONPATH": ROOT})
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 8


def imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_the_reference_imports_nothing_of_the_program():
    files = [os.path.join(HERE, "check.py")] + [
        os.path.join(HERE, kind, f) for kind in ("reference", "modes")
        for f in os.listdir(os.path.join(HERE, kind)) if f.endswith(".py")]
    for f in files:
        tops = set(imported(f))
        assert not tops & {"swipe_tpu_torch", "swipe_tpu", "jax"}, f
        assert tops <= {"__future__", "math", "os", "re", "numpy", "torch",
                        "portbench"}, (f, tops)
