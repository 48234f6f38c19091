"""The yardstick's arithmetic: published peaks of one NVIDIA H100 SXM, the
least time of a paged-attention (K1), flash-attention (K2) and page-walk
(K3) launch, and the model FLOPs of a prefill or a decode step.

The bounds are frozen copies of the chip smoke run's ``paged_bound``,
``flash_bound`` and ``pte_bound``, so that the yardstick does not move when
the program changes: bytes count each input read once and each output
written once, operations count the live (query head, slot) pairs, and the
bound is the larger of bytes over HBM bandwidth and operations over peak.
The rates assume the card's full 700 W; ``power_limit`` reads the card's
own limit, which every share is reported beside.
"""
from __future__ import annotations

import shutil
import subprocess
from typing import Optional, Sequence

#: NVIDIA's data sheet, H100 SXM, dense: HBM bytes/s and FLOP/s by input type
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
ELEMENT_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def paged_bound(B: int, H: int, K: int, hd: int, MB: int, n_live: int,
                dtype: str = "bfloat16") -> float:
    """Seconds: one K1 launch over B rows (H query heads, K kv heads) whose
    tables have MB columns and ``n_live`` live slots in all.  Bytes: the
    live slots' K and V rows, q, the float32 output, the tables and the
    lengths; operations: 4 hd a live (query head, slot) pair."""
    e = ELEMENT_BYTES[dtype]
    nbytes = (2 * n_live * K * hd * e + B * H * hd * e + B * H * hd * 4
              + B * MB * 4 + B * 4)
    flops = 4 * H * hd * n_live
    return max(nbytes / HBM_BPS, flops / PEAK_FLOPS[dtype])


def causal_pairs(S: int) -> int:
    """Visible (query, key) pairs of one causal sequence of S."""
    return S * (S + 1) // 2


def flash_bound(B: int, H: int, K: int, S: int, hd: int,
                dtype: str = "bfloat16") -> float:
    """Seconds: one causal K2 launch over B rows of S.  Operations: 4 hd a
    visible pair; bytes: q, k and v read once, the float32 output."""
    e = ELEMENT_BYTES[dtype]
    flops = 4 * B * H * hd * causal_pairs(S)
    nbytes = (B * H * S * hd + 2 * B * K * S * hd) * e + B * H * S * hd * 4
    return max(nbytes / HBM_BPS, flops / PEAK_FLOPS[dtype])


def pte_bound(M: int, degree: int, n_mutations: int = 0,
              n_slots: int = 0) -> float:
    """Seconds: one K3 launch walking M ids with windows of 2^degree
    entries, draining ``n_mutations`` that store to ``n_slots`` slots."""
    W = 1 << degree
    nbytes = M * (4 + 4 * W + 4 + 1 + 4 * W) + 13 * n_mutations + 4 * n_slots
    return nbytes / HBM_BPS


# ------------------------------------------------------------- model FLOPs
def layer_matmul_params(model: dict) -> int:
    """Weights one token multiplies through in one layer: q, k, v, o and
    the FFN (two products, three with a gate)."""
    D, F_, hd = model["d_model"], model["d_ff"], model["head_dim"]
    H, K = model["n_heads"], model["n_kv_heads"]
    ffn = (3 if model["ffn_act"] in ("silu", "geglu") else 2) * D * F_
    return D * H * hd + 2 * D * K * hd + H * hd * D + ffn


def _head(model: dict) -> int:
    return 2 * model["d_model"] * model["vocab_size"]


def prefill_flops(model: dict, S: int, rows: int = 1) -> float:
    """Model FLOPs of prefilling ``rows`` prompts of S: every layer's
    products for each token, causal attention, the head at the last
    position (the only one the prefill computes)."""
    L, H, hd = model["n_layers"], model["n_heads"], model["head_dim"]
    per_row = (2 * layer_matmul_params(model) * S * L
               + 4 * H * hd * causal_pairs(S) * L + _head(model))
    return float(rows) * per_row


def decode_flops(model: dict, lens: Sequence[int]) -> float:
    """Model FLOPs of one decode step of rows whose lengths, the new token
    included, are ``lens``."""
    L, H, hd = model["n_layers"], model["n_heads"], model["head_dim"]
    per_token = 2 * layer_matmul_params(model) * L + _head(model)
    return float(len(lens) * per_token + 4 * H * hd * L * sum(lens))


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reports them, or
    None where it cannot be read."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None
