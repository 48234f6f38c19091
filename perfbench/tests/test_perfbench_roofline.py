"""FLOP and byte counts against hand-worked numbers."""
import pytest

from perfbench import roofline

TINY = {"n_layers": 2, "d_model": 8, "n_heads": 2, "n_kv_heads": 1,
        "head_dim": 4, "d_ff": 16, "vocab_size": 10, "ffn_act": "relu2",
        "dtype": "bfloat16"}


def test_layer_params():
    # q 8x8, k and v 8x4 each, o 8x8, FFN 2 x 8x16 (no gate)
    assert roofline.layer_matmul_params(TINY) == 64 + 64 + 64 + 256
    gated = dict(TINY, ffn_act="silu")
    assert roofline.layer_matmul_params(gated) == 64 + 64 + 64 + 384


def test_prefill_and_decode_flops():
    # per token 2 x 448 x 2 layers = 1792; S = 3: 5376; attention
    # 4 x 2 heads x 4 x 6 pairs x 2 layers = 384; head 2 x 8 x 10 = 160
    assert roofline.prefill_flops(TINY, 3) == 5376 + 384 + 160
    assert roofline.prefill_flops(TINY, 3, rows=2) == 2 * (5376 + 384 + 160)
    # two rows at lengths 4 and 5: 2 x (1792 + 160) + 4 x 2 x 4 x 2 x 9
    assert roofline.decode_flops(TINY, [4, 5]) == 2 * 1952 + 576


def test_paged_bound_bytes_and_flops():
    # 2 rows, 8 heads / 2 kv heads, hd 128, 10 columns, 3000 live slots
    nbytes = (2 * 3000 * 2 * 128 * 2 + 2 * 8 * 128 * 2 + 2 * 8 * 128 * 4
              + 2 * 10 * 4 + 2 * 4)
    flops = 4 * 8 * 128 * 3000
    assert roofline.paged_bound(2, 8, 2, 128, 10, 3000) == pytest.approx(
        max(nbytes / 3.35e12, flops / 989e12))
    assert nbytes / 3.35e12 > flops / 989e12        # K1 is bound by bytes


def test_flash_bound_operations():
    # causal S = 1024: 524 800 visible pairs a (row, head)
    assert roofline.causal_pairs(1024) == 524800
    flops = 4 * 16 * 40 * 128 * 524800
    assert roofline.flash_bound(16, 40, 8, 1024, 128) == pytest.approx(
        flops / 989e12)
    # the chip smoke run's Qwen3-14B K2 row reads 0.1739 ms
    assert roofline.flash_bound(16, 40, 8, 1024, 128) * 1e3 == pytest.approx(
        0.1739, abs=5e-5)


def test_pte_bound():
    # 1 104 ids at degree 3, no mutations: the smoke run's K3 row, 0.0000241 ms
    assert roofline.pte_bound(1104, 3) * 1e3 == pytest.approx(2.41e-5, rel=0.01)


def test_paged_bound_matches_smoke_row():
    # Qwen3-14B's K1 row: q [16,40,128], 8 kv heads, tables [16,69], every
    # row 1 057 long: 0.02083 ms
    b = roofline.paged_bound(16, 40, 8, 128, 69, 16 * 1057)
    assert b * 1e3 == pytest.approx(0.02083, abs=5e-5)
