"""Nothing the benchmark runs imports JAX or the JAX package: top-level
names compared whole."""
import ast
import subprocess
import sys

import pytest

from perfbench.harness import imports, spec


@pytest.mark.parametrize("names,found", [
    (["repro_torch", "repro_torch.models.lm"], []),
    (["repro", "numpy"], ["repro"]),
    (["repro.models.lm"], ["repro"]),
    (["jax_utils", "jaxtyping", "flaxen"], []),
    (["jax.numpy", "jaxlib.xla_client", "flax.linen"],
     ["flax", "jax", "jaxlib"]),
])
def test_whole_name_compare(names, found):
    assert imports.forbidden(names) == found


def _imports_of(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    p for p in (spec.ROOT / "perfbench").rglob("*.py")
    if "tests" not in p.relative_to(spec.ROOT / "perfbench").parts),
    ids=lambda p: p.relative_to(spec.ROOT).as_posix())
def test_sources_import_no_jax(path):
    tops = {m.split(".")[0] for m in _imports_of(path)}
    assert not tops & (imports.FORBIDDEN | {"benchmarks"})


def test_reference_imports_nothing_of_the_port():
    for path in (spec.ROOT / "perfbench" / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports_of(path)}
        assert "repro_torch" not in tops, path


def test_loaded_modules_after_a_whole_import():
    code = ("import sys; sys.path[:0] = ['src', '.']\n"
            "import perfbench.run, perfbench.control\n"
            "from perfbench.harness import spec, imports\n"
            "from perfbench.drivers import lm_train\n"
            "from perfbench.reference import lm\n"
            "import repro_torch.models, repro_torch.data, repro_torch.dist\n"
            "import repro_torch.launch.mesh, repro_torch.optim\n"
            "for m in spec.benchmark()['per_layer']: spec.reader(m['name'])\n"
            "print(imports.forbidden())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
