"""The plain reference against the program at a small size, and the
weights the benchmark makes."""
import math

import pytest
import torch

from repro_torch.models.transformer import forward_lm

from perfbench.harness import program_config
from perfbench.reference import dense

SMOKE = {"family": "dense", "n_layers": 2, "d_model": 64, "n_heads": 4,
         "n_kv_heads": 2, "head_dim": 16, "d_ff": 160, "vocab_size": 512,
         "rope_theta": 10000.0, "tie_embeddings": False, "dtype": "float32",
         "kv_block_tokens": 16}


@pytest.mark.parametrize("act", ["relu2", "silu"])
def test_reference_matches_program_float32(act):
    model = dict(SMOKE, ffn_act=act)
    w = dense.make_weights(model, 2 ** 31 + 5, "cpu")
    cfg = program_config({"name": "t", "model": model})
    tokens = torch.randint(0, 512, (2, 40), generator=torch.Generator().manual_seed(1))
    want, _ = forward_lm(cfg, dense.port_params(model, w), tokens, remat=False)
    got = dense.logits(model, w, list(tokens), [range(40)] * 2)
    for g, x in zip(got, want):
        assert torch.allclose(g, x.float(), atol=1e-4, rtol=1e-4)


def test_weights_seeded_and_scaled():
    model = dict(SMOKE, ffn_act="relu2", dtype="bfloat16", d_model=256, d_ff=512)
    a = dense.make_weights(model, 7, "cpu")
    b = dense.make_weights(model, 7, "cpu")
    c = dense.make_weights(model, 8, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["wq"], c["wq"])
    assert a["wq"].dtype == torch.bfloat16 and a["wq"].shape == (2, 256, 64)
    assert a["w_out"].float().std().item() == pytest.approx(1 / math.sqrt(512), rel=0.05)
    assert "w_gate" not in a and "lm_head" in a


def test_control_rounds_to_fp8():
    w = torch.randn(64, 32)
    q = dense._fp8(w)
    rel = ((q - w).abs() / w.abs().amax(0)).max().item()
    assert 0 < rel < 2 ** -4          # e4m3 keeps 3 bits of mantissa
