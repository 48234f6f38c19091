"""The import check, and what the benchmark's modules load."""
import ast
import subprocess
import sys
from pathlib import Path

from perfbench.imports import forbidden_modules

ROOT = Path(__file__).resolve().parents[2]


def test_top_level_names_compared_whole():
    names = ["repro_torch", "repro_torch.models", "repro", "repro.core",
             "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "jaxtyping", "reproducible", "flaxen"]
    assert forbidden_modules(names) == sorted(
        ["repro", "repro.core", "jax", "jax.numpy", "jaxlib.xla_client",
         "flax.linen"])


def _loaded_by(code):
    out = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
         f"{code}\nprint(sorted(sys.modules))"],
        capture_output=True, text=True, check=True, timeout=300)
    return eval(out.stdout.strip().splitlines()[-1])


def test_harness_loads_no_jax_or_reference_package():
    mods = _loaded_by("import perfbench.run, perfbench.harness, "
                      "perfbench.driver, perfbench.check")
    assert "repro_torch" in mods
    assert forbidden_modules(mods) == []


def test_reference_imports_nothing_of_the_program():
    mods = _loaded_by("import perfbench.reference.dense")
    assert not [m for m in mods if m.split(".")[0] in
                ("repro_torch", "repro", "jax", "jaxlib", "flax")]
    for path in (ROOT / "perfbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not set(tops) & {"repro_torch", "repro", "jax", "flax",
                                    "jaxlib", "perfbench"}, path
