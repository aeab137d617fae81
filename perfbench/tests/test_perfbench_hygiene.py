"""Nothing a run loads is JAX or the JAX package, and the reference
imports nothing of the program."""
import ast
import subprocess
import sys

from conftest import HERE, ROOT

PROGRAM = "taichi_3d_gaussian_splatting_tpu_torch"
JAX_SIDE = {"jax", "jaxlib", "flax", "taichi_3d_gaussian_splatting_tpu"}


def imported_roots(path):
    """Top-level names of every module a file imports (whole names)."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_module_of_jax_side_after_a_run():
    code = (
        "import sys; sys.path.insert(0, 'perfbench/tests');"
        "from conftest import tiny_cell; from perfbench import run;"
        "r = run.run_cell(tiny_cell('truck-428k.train-w8-resident'), 11, 0.2,"
        " False, device='cpu');"
        "r2 = run.run_cell(tiny_cell('truck-2080k.render-544p'), 11, 0.2,"
        " False, device='cpu');"
        "print('FOUND', run.forbidden_modules(),"
        " sorted({m.split('.')[0] for m in sys.modules}))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [x for x in r.stdout.splitlines() if x.startswith("FOUND")][-1]
    assert line.startswith("FOUND []"), line
    assert PROGRAM in line  # the run did load the port


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((HERE / "reference").glob("*.py"))
    assert files
    for f in files:
        roots = imported_roots(f)
        assert PROGRAM not in roots and not roots & JAX_SIDE, (f, roots)


def test_the_harness_imports_no_jax_side():
    for f in sorted(HERE.rglob("*.py")):
        roots = imported_roots(f)
        assert not roots & JAX_SIDE, (f, roots & JAX_SIDE)


def test_forbidden_names_compare_whole_top_level_names():
    from perfbench import run

    saved = dict(sys.modules)
    try:
        sys.modules["taichi_3d_gaussian_splatting_tpu_torch_x"] = sys
        assert "taichi_3d_gaussian_splatting_tpu_torch_x" not in \
            run.forbidden_modules()
        sys.modules["taichi_3d_gaussian_splatting_tpu.ops"] = sys
        assert run.forbidden_modules() == [
            "taichi_3d_gaussian_splatting_tpu.ops"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
