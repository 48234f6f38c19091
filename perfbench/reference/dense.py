"""Plain reference of a dense, decoder-only, global-attention transformer,
and the weights the benchmark makes for it.

This file imports nothing of the program under test.  It holds:

* ``make_weights``: every weight of the model drawn on the device from one
  ``torch.Generator``, one call a kind of leaf (all layers' ``wq`` at once,
  and so on), in the type the model is served in.  These are the benchmark's
  inputs: the program gets views of them (``port_params``, plain nested
  dictionaries in the layout the program reads) and the reference reads the
  same tensors.
* ``logits``: the model's forward pass without a cache, float32, with TF32
  off, one layer at a time (each layer's weights widened to float32 only
  while it runs), over a few whole sequences, returning the logits at the
  positions asked for.
* ``control_weights``: the same weights rounded to fp8 (e4m3, one scale an
  output channel), the nearest precision below bfloat16: the control that
  a sound comparison has to reject.

The equations are those of the program's model definition, which departs
from the published models in three places (``PERF.md`` names them): the
input embedding is scaled by sqrt(d_model) rounded to bfloat16, the norms
are RMSNorm with a ``(1 + scale)`` gain and eps 1e-6 (Nemotron-4 publishes
LayerNorm), and RoPE rotates split halves of every head dimension.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterable, List, Optional, Sequence

import torch
import torch.nn.functional as F

NORM_EPS = 1e-6
#: the norms' gains are 1 + scale; the benchmark draws scale ~ N(0, 0.1^2)
NORM_SCALE_STD = 0.1
FP8_MAX = 448.0                     # largest finite float8_e4m3fn

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def _gated(model: dict) -> bool:
    return model["ffn_act"] in ("silu", "geglu")


def leaf_shapes(model: dict) -> Dict[str, tuple]:
    """The stacked shape of every kind of leaf: layer leaves lead with the
    layer count."""
    L, D, F_ = model["n_layers"], model["d_model"], model["d_ff"]
    H, K, hd, V = (model["n_heads"], model["n_kv_heads"], model["head_dim"],
                   model["vocab_size"])
    shapes = {"embedding": (V, D), "final_norm": (D,),
              "norm1": (L, D), "norm2": (L, D),
              "wq": (L, D, H * hd), "wk": (L, D, K * hd), "wv": (L, D, K * hd),
              "wo": (L, H * hd, D), "w_in": (L, D, F_), "w_out": (L, F_, D)}
    if _gated(model):
        shapes["w_gate"] = (L, D, F_)
    if not model["tie_embeddings"]:
        shapes["lm_head"] = (D, V)
    return shapes


@torch.no_grad()
def make_weights(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight from ``seed``: one ``randn`` a kind of leaf on the
    device, in the served type, scaled in place to N(0, 1 / fan_in) with
    the program's own convention for the fan-in (a matrix's first
    dimension, the embedding's included), the norms' scales to N(0,
    0.1^2)."""
    dtype = DTYPES[model["dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {}
    for name, shape in leaf_shapes(model).items():
        t = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        if name in ("norm1", "norm2", "final_norm"):
            std = NORM_SCALE_STD
        else:
            std = 1.0 / math.sqrt(shape[-2])
        out[name] = t.mul_(std)
    return out


def port_params(model: dict, w: Dict[str, torch.Tensor]) -> dict:
    """The program's parameter tree over views of ``w``: ``groups`` (one
    group of ``n_layers`` layers, each ``norm1``, ``attn``, ``norm2``,
    ``ffn``), ``final_norm``, ``embedding`` and ``lm_head``."""
    ffn_keys = ("w_in", "w_out") + (("w_gate",) if _gated(model) else ())
    layers = [{"norm1": {"scale": w["norm1"][i]},
               "attn": {k: w[k][i] for k in ("wq", "wk", "wv", "wo")},
               "norm2": {"scale": w["norm2"][i]},
               "ffn": {k: w[k][i] for k in ffn_keys}}
              for i in range(model["n_layers"])]
    params = {"groups": [layers], "final_norm": {"scale": w["final_norm"]},
              "embedding": w["embedding"]}
    if "lm_head" in w:
        params["lm_head"] = w["lm_head"]
    return params


# ----------------------------------------------------------------- reference
@contextlib.contextmanager
def exact_float32():
    """float32 products in float32: TF32 off for the matmuls and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def _rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + NORM_EPS)
    return x * (1.0 + scale.float())


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-halves RoPE of x [S, heads, hd] at positions 0..S-1."""
    S, _, hd = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
               ) -> torch.Tensor:
    """Causal GQA of one sequence: q [S, H, hd], k / v [S, K, hd] ->
    [S, H * hd], one kv head's query heads at a time."""
    S, H, hd = q.shape
    K = k.shape[1]
    G = H // K
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    out = torch.empty(S, H, hd, dtype=torch.float32, device=q.device)
    for j in range(K):
        qj = q[:, j * G:(j + 1) * G].transpose(0, 1)          # [G, S, hd]
        s = (qj @ k[:, j].T) / math.sqrt(hd)                  # [G, S, S]
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out[:, j * G:(j + 1) * G] = (p @ v[:, j]).transpose(0, 1)
    return out.reshape(S, H * hd)


def _act(name: str, h: torch.Tensor, gate: Optional[torch.Tensor]
         ) -> torch.Tensor:
    if name == "silu":
        return F.silu(gate) * h
    if name == "geglu":
        return F.gelu(gate, approximate="tanh") * h
    if name == "relu2":
        return torch.square(F.relu(h))
    if name == "gelu":
        return F.gelu(h, approximate="tanh")
    raise ValueError(f"unknown activation {name}")


def _fp8(w: torch.Tensor) -> torch.Tensor:
    """w [in, out] rounded to float8_e4m3fn with one scale an output
    column, returned in float32."""
    w = w.float()
    scale = w.abs().amax(dim=0, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


@torch.no_grad()
def logits(model: dict, w: Dict[str, torch.Tensor],
           sequences: Sequence[torch.Tensor], positions: Sequence[Iterable[int]],
           *, fp8: bool = False) -> List[torch.Tensor]:
    """The logits [len(positions[i]), V] float32 at the positions asked for
    of each token sequence (int64 on the weights' device), by the forward
    pass without a cache.  ``fp8``: every product's weight rounded to fp8
    first (the control)."""
    L, D = model["n_layers"], model["d_model"]
    H, K, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    theta = float(model["rope_theta"])
    act = model["ffn_act"]
    widen = _fp8 if fp8 else (lambda t: t.float())
    embed_scale = torch.tensor(D ** 0.5, dtype=DTYPES[model["dtype"]]).item()
    with exact_float32():
        xs = [w["embedding"][s].float() * embed_scale for s in sequences]
        for i in range(L):
            wq, wk, wv, wo = (widen(w[n][i]) for n in ("wq", "wk", "wv", "wo"))
            w_in, w_out = widen(w["w_in"][i]), widen(w["w_out"][i])
            w_gate = widen(w["w_gate"][i]) if "w_gate" in w else None
            for j, x in enumerate(xs):
                S = x.shape[0]
                h = _rms(x, w["norm1"][i])
                q = _rope((h @ wq).view(S, H, hd), theta)
                k = _rope((h @ wk).view(S, K, hd), theta)
                v = (h @ wv).view(S, K, hd)
                x = x + _attention(q, k, v) @ wo
                h = _rms(x, w["norm2"][i])
                gate = h @ w_gate if w_gate is not None else None
                xs[j] = x + _act(act, h @ w_in, gate) @ w_out
            del wq, wk, wv, wo, w_in, w_out, w_gate
        head = widen(w["lm_head"] if "lm_head" in w else w["embedding"].T)
        out = []
        for x, pos in zip(xs, positions):
            rows = torch.as_tensor(list(pos), dtype=torch.long, device=x.device)
            out.append(_rms(x[rows], w["final_norm"]) @ head)
        return out
