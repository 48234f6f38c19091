"""The other half of ``test_torch_model_axis_families``' per-arch cases:
Gemma-3 (windowed ring layers beside global ones), Kimi-K2 (expert
parallelism, its dense first layer and shared expert by ``ff``), Mamba-2
(the SSD split by head) and Whisper (the encoder-decoder) over the model
axis, each case run by that file's own test function (the reference's
unsharded functions within 1e-4, the port's model 1 within 1e-5, Kimi's
routes on every shard, the clip's norm, and Mamba-2's gloo pair bit-equal
to ``LoopPods(2)``).  Two files, so that two workers share the cases."""
from __future__ import annotations

import pytest

pytest.importorskip("torch")

from test_torch_model_axis_families import (  # noqa: E402
    CASES, HERE, MOE,
    test_torch_clip_norm_over_split_leaves_equals_model_one as _clip_norm,
    test_torch_families_match_model_one as _model_one,
    test_torch_families_match_the_reference as _reference,
    test_torch_families_on_gloo_equal_loop_pods as _gloo,
    test_torch_moe_routes_equal_model_one_on_every_shard as _routes)

THERE = ["gemma3_4b", "kimi_k2_1t_a32b", "mamba2_370m", "whisper_base"]
assert not set(THERE) & set(HERE)


@pytest.mark.parametrize("t,layout", CASES)
@pytest.mark.parametrize("arch", THERE)
def test_torch_families_match_the_reference(arch, t, layout):
    _reference(arch, t, layout)


@pytest.mark.parametrize("t,layout", CASES)
@pytest.mark.parametrize("arch", THERE)
def test_torch_families_match_model_one(arch, t, layout):
    _model_one(arch, t, layout)


@pytest.mark.parametrize("t,layout", CASES)
@pytest.mark.parametrize("arch", [a for a in MOE if a in THERE])
def test_torch_moe_routes_equal_model_one_on_every_shard(arch, t, layout):
    _routes(arch, t, layout)


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("arch", THERE)
def test_torch_clip_norm_over_split_leaves_equals_model_one(arch, t):
    _clip_norm(arch, t)


@pytest.mark.parametrize("arch", ["mamba2_370m"])
def test_torch_families_on_gloo_equal_loop_pods(tmp_path, arch):
    _gloo(tmp_path, arch)
