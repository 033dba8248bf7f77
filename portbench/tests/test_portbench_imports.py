"""Nothing the benchmark runs imports JAX or the JAX package; the
reference imports nothing of the program either. Names are compared by
their top-level module, whole: the program's name begins with the JAX
package's."""

import ast
import shutil
import subprocess
import sys

import pytest

from portbench import manifest, run

FORBIDDEN = {"jax", "jaxlib", "flax", "nbldpc_tpu"}
PROGRAM = "nbldpc_tpu_torch"
# the yardstick: imports nothing of the program
YARDSTICK = ("reference.py", "check.py", "bounds.py", "trace.py")


def _top_level_imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def _sources():
    return sorted(p for p in manifest.HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(manifest.HERE)))
def test_no_jax_in_the_harness(path):
    assert not _top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", YARDSTICK)
def test_the_yardstick_imports_nothing_of_the_program(name):
    names = _top_level_imports(manifest.HERE / name)
    assert PROGRAM not in names and not names & FORBIDDEN
    for metric in (manifest.HERE / "metrics").glob("*.py"):
        assert PROGRAM not in _top_level_imports(metric)


@pytest.mark.parametrize("modules,found", [
    (["nbldpc_tpu_torch", "nbldpc_tpu_torch.sim", "torch"], []),
    (["nbldpc_tpu", "nbldpc_tpu_torch"], ["nbldpc_tpu"]),
    (["jaxlib.xla_client", "jaxtyping", "flaxen"], ["jaxlib"]),
    (["jax", "flax.linen"], ["flax", "jax"]),
])
def test_the_run_time_check_compares_whole_names(modules, found):
    assert run.forbidden_modules(dict.fromkeys(modules)) == found


def test_a_tree_of_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(manifest.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "-m", "portbench", "--workload",
                           "gf16_qspa.waterfall", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
