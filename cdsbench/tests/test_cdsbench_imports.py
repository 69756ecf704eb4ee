"""Nothing the benchmark runs loads JAX or the JAX package, and the
yardstick loads nothing of the program. Top-level module names are
compared whole: the port's name begins with the JAX package's."""

import ast
import glob
import os
import subprocess
import sys

from cdsbench import run

HERE = os.path.dirname(run.__file__)
JAX_NAMES = {"jax", "jaxlib", "flax", "colormipsearch_tpu"}
PROGRAM = "colormipsearch_tpu_torch"
# the yardstick: generator, reference, comparison, peaks, trace reading
# and the metric readers, which may not import the program
YARDSTICK = ["data.py", "reference.py", "check.py", "roofline.py",
             "trace.py", *[os.path.relpath(p, HERE) for p in glob.glob(
                 os.path.join(HERE, "metrics", "*.py"))]]


def top_level_imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_in_the_harness():
    for path in glob.glob(os.path.join(HERE, "*.py")) + glob.glob(
            os.path.join(HERE, "metrics", "*.py")):
        assert not top_level_imports(path) & JAX_NAMES, path


def test_yardstick_imports_nothing_of_the_program():
    for rel in YARDSTICK:
        names = top_level_imports(os.path.join(HERE, rel))
        assert PROGRAM not in names and not names & JAX_NAMES, rel


def test_a_run_loads_no_jax():
    code = ("import sys; from cdsbench import run; "
            "from cdsbench.tests.tiny_cell import run_tiny, SEEDS; "
            "run_tiny(SEEDS[4], seconds=2.0); "
            "print(','.join(run.forbidden_loaded()) or 'none')")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "none"


def test_whole_names_are_compared():
    sys.modules.setdefault("colormipsearch_tpu_torch_probe", sys)
    try:
        assert "colormipsearch_tpu" not in run.forbidden_loaded()
    finally:
        del sys.modules["colormipsearch_tpu_torch_probe"]
