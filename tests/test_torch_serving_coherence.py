"""The port's ``serving_coherence`` benchmark against the JAX package's: the
same rows, counter for counter, and the same budget row.  ``tok_per_s`` (a
CPU wall-clock rate) and the fields the port adds are exempt."""
from __future__ import annotations

import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from benchmarks import serving_coherence as reference  # noqa: E402
from repro_torch.benchmarks import serving_coherence  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ADDED = {"device", "n_layers", "prefill_ms", "decode_step_ms", "logits_finite"}


def test_torch_serving_coherence_rows_equal_reference():
    want = reference.main(quick=True)
    got = serving_coherence.main(quick=True, device="cpu")
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert set(g) == set(w) | (ADDED if "tokens" in w else set())
        assert {k: g[k] for k in w if k != "tok_per_s"} == \
            {k: v for k, v in w.items() if k != "tok_per_s"}
    serve_rows = got[:3]
    assert [r["mode"] for r in serve_rows] == ["local", "eager", "numapte"]
    assert all(r["device"] == "cpu" and r["logits_finite"] and r["tok_per_s"] > 0
               for r in serve_rows)
    assert serve_rows[2]["fetches"] > 0 and serve_rows[0]["fetches"] == 0
    assert got[3]["ratio"] == round(got[3]["eager"] / got[3]["numapte"], 1)


def test_torch_serving_coherence_imports_without_jax_or_repro():
    code = ("import sys\n"
            "sys.modules['jax'] = None; sys.modules['repro'] = None\n"
            "sys.modules['benchmarks'] = None\n"
            "from repro_torch.benchmarks import serving_coherence\n"
            "assert callable(serving_coherence.main)\n"
            "bad = [m for m in sys.modules if m.startswith(('jax.', 'repro.'))]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
    assert out.returncode == 0, out.stderr
