"""The port stands on its own: it imports neither jax nor the JAX package,
and its configs equal the JAX package's field for field."""
from __future__ import annotations

import dataclasses
import pathlib
import pkgutil
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODULES = sorted(m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch."))
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


def test_torch_port_has_the_reference_layout():
    for sub in ("kernels.paged_attention.ops", "kernels.flash_attention.ref",
                "kernels.pte_gather.ops", "kernels._build", "pagedpt.host",
                "pagedpt.blocktable", "kvcache.manager", "kvcache.gather",
                "models.transformer", "models.attention", "models.common",
                "models.ffn", "models.moe", "configs.qwen3_14b", "configs.yi_6b",
                "configs.gemma3_4b", "configs.qwen3_moe_235b_a22b",
                "configs.kimi_k2_1t_a32b", "configs.nemotron_4_15b",
                "configs.chameleon_34b", "configs.mamba2_370m",
                "configs.recurrentgemma_2b", "configs.whisper_base",
                "models.ssm", "models.rglru", "launch.serve",
                "benchmarks.serving_coherence", "kernels.flash_attention.ops",
                "optim.adamw", "data.pipeline", "checkpoint.store",
                "runtime.trainer", "launch.train", "distributed.pods",
                "distributed.compression", "pagedpt.coherence", "launch.mesh",
                "launch.specs", "core", "core.topology", "core.costmodel",
                "core.tlb", "core.pagetable", "core.shootdown",
                "core.shootdown_batch", "core.config", "kernels.fifo_miss",
                "kernels.fifo_miss.ops", "kernels.fifo_miss.ref", "core.batch",
                "core.sim", "core.mm_batch", "core.trace", "core.malloc",
                "core.workloads", "serving", "serving.loop"):
        assert f"repro_torch.{sub}" in MODULES


def test_torch_port_imports_with_jax_and_repro_blocked():
    """Every module of the port imports in a process where ``jax`` and
    ``repro`` cannot be imported at all."""
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.startswith(('jax.', 'repro.'))]\n"
        "assert not bad, bad\n"
        "print('imported', len(" f"{MODULES!r}" "))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == f"imported {len(MODULES)}"


@pytest.mark.parametrize("path", ["chip_smoke.py"] + sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "src" / "repro_torch").rglob("*.py")))
def test_torch_sources_name_no_jax_import(path):
    assert not FORBIDDEN.search((ROOT / path).read_text()), path


def test_torch_chip_smoke_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE_CONFIG"])
@pytest.mark.parametrize("arch", ["qwen3_14b", "yi_6b", "gemma3_4b",
                                  "qwen3_moe_235b_a22b", "kimi_k2_1t_a32b",
                                  "nemotron_4_15b", "chameleon_34b",
                                  "mamba2_370m", "recurrentgemma_2b",
                                  "whisper_base"])
def test_torch_configs_equal_reference_field_for_field(arch, which):
    import importlib
    ours = getattr(importlib.import_module(f"repro_torch.configs.{arch}"), which)
    theirs = getattr(importlib.import_module(f"repro.configs.{arch}"), which)
    ours_d, theirs_d = dataclasses.asdict(ours), dataclasses.asdict(theirs)
    assert list(ours_d) == list(theirs_d)
    for name in ours_d:
        a, b = ours_d[name], theirs_d[name]
        if name in ("dtype", "param_dtype"):      # dtypes by name
            a, b = str(a).replace("torch.", ""), b.__name__ if hasattr(b, "__name__") else str(b)
        assert a == b, name
    assert ours.resolved_head_dim == theirs.resolved_head_dim
    assert ours.q_per_kv == theirs.q_per_kv
    assert (ours.d_inner, ours.ssm_n_heads) == (theirs.d_inner, theirs.ssm_n_heads)
    from repro_torch import configs
    getter = configs.get_config if which == "CONFIG" else configs.get_smoke_config
    assert getter(arch) is ours and getter(arch.replace("_", "-")) is ours


def test_torch_unported_archs_raise():
    """Every arch of the reference is ported: the registries hold the same
    ten, and a name neither knows raises as the reference's does."""
    from repro import configs as reference
    from repro_torch import configs
    assert sorted(configs.ARCH_IDS) == sorted(reference.ARCH_IDS)
    for registry in (configs, reference):
        with pytest.raises(ModuleNotFoundError, match="mamba3_1b"):
            registry.get_config("mamba3_1b")
        with pytest.raises(ModuleNotFoundError, match="mamba3_1b"):
            registry.get_smoke_config("mamba3-1b")
