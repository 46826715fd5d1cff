"""Nothing under benchmark/ imports JAX or the JAX package, and nothing of
the reference imports the program: each import's top-level name compared
whole (the program's name begins with the JAX package's)."""

import ast
import os

import pytest

from benchmark import harness as H

JAX = ("jax", "jaxlib", "flax", "elevation_mapping_cupy_tpu")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def _files(sub=""):
    root = os.path.join(H.BENCH_DIR, sub)
    return [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs if f.endswith(".py")]


def _top(names, banned):
    return [n for n in names if n.split(".")[0] in banned]


def test_the_scan_reaches_every_part():
    rel = {os.path.relpath(p, H.BENCH_DIR) for p in _files()}
    for sub in ("run.py", "harness.py", "control.py", "drivers/service_stream.py", "drivers/batched_steps.py",
                "reference/update.py", "reference/replay.py", "traffic/lidar_scene.py", "traffic/terrain_clouds.py",
                "metrics/k1_roofline.robot.py"):
        assert sub.replace("/", os.sep) in rel


def test_nothing_imports_jax_or_the_jax_package():
    for path in _files():
        assert not _top(_imports(path), JAX), path


def test_the_reference_imports_nothing_of_the_program():
    for path in _files("reference"):
        assert not _top(_imports(path), JAX + ("elevation_mapping_cupy_torch",)), path


@pytest.mark.parametrize("line,banned", [
    ("import jax.numpy as jnp", JAX),
    ("from elevation_mapping_cupy_tpu import core", JAX),
    ("def f():\n    import jaxlib", JAX),
    ("from elevation_mapping_cupy_torch.ops import scatter", ("elevation_mapping_cupy_torch",)),
])
def test_the_scan_catches_a_planted_import(tmp_path, line, banned):
    src = open(os.path.join(H.BENCH_DIR, "reference", "params.py")).read() + "\n" + line + "\n"
    path = tmp_path / "params.py"
    path.write_text(src)
    assert _top(_imports(str(path)), banned)


def test_the_program_name_is_not_taken_for_the_jax_package():
    assert not _top(["elevation_mapping_cupy_torch.core"], JAX)
