"""Plain reference of DeepSeek-V3's block (Moonlight-16B-A3B): multi-head
latent attention, leading dense SwiGLU layers, then sigmoid-routed experts
with shared experts, and the weights the benchmark makes for it.

This file imports nothing of the program under test.  It holds, as
``dense.py`` does for the dense configurations:

* ``make_weights``: every weight drawn on the device from one
  ``torch.Generator``, one call a kind of leaf (all layers' ``wq`` at once,
  all MoE layers' experts at once, and so on), in the served type;
* ``port_params``: views of them in the program's parameter layout;
* ``logits``: the forward pass without a cache, float32 with TF32 off, one
  layer at a time (each matrix widened to float32 only while it runs; the
  experts one at a time), over a few whole sequences, returning the logits
  at the positions asked for; ``fp8=True`` computes every product in fp8
  (e4m3): a weight with one scale an output column, an activation (the
  attention's q, k, P and v included) with one scale a row: the control.

The layer, as DeepSeek-V3 publishes it (``q_lora_rank`` null):

    h = norm1(x)
    q = h wq -> per head [q_nope (dn), q_pe (dr)];  q_pe = RoPE(q_pe)
    [c, k_pe] = h w_kv_a;  c = kv_norm(c);  k_pe = RoPE(k_pe), one per token
    [k_nope, v] = c w_kv_b, per head (dn, dv)
    attn = softmax([q_nope, q_pe] . [k_nope, k_pe] / sqrt(dn + dr)) v   (causal)
    x = x + attn wo
    h = norm2(x)
    dense layer:  x = x + (silu(h w_gate) * h w_in) w_out
    MoE layer:    s = sigmoid(h router) (float32);  top k of s + bias;
                  g = s[top] / sum(s[top]) * routed_scale;
                  x = x + sum_top g_e expert_e(h) + shared(h)

Departures, the program's shared conventions (the configuration's
``assumed`` lists them): the input embedding is scaled by sqrt(d_model)
rounded to bfloat16; every norm (the latent's too) is an RMSNorm with a
``(1 + scale)`` gain and eps 1e-6 where the published norm is a plain
RMSNorm at eps 1e-5; RoPE rotates split halves of the rope columns where
DeepSeek rotates interleaved pairs (a fixed permutation of those 64
columns); the correction bias is drawn from the seed, N(0, bias_std^2).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterable, List, Sequence

import torch
import torch.nn.functional as F

NORM_EPS = 1e-6
#: the norms' gains are 1 + scale; the benchmark draws scale ~ N(0, 0.1^2)
NORM_SCALE_STD = 0.1
FP8_MAX = 448.0                     # largest finite float8_e4m3fn
DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}
NORMS = ("norm1", "norm2", "final_norm", "kv_norm")


def _widths(model: dict):
    return (model["n_heads"], model["qk_nope_head_dim"],
            model["qk_rope_head_dim"], model["v_head_dim"],
            model["kv_lora_rank"])


def leaf_shapes(model: dict) -> Dict[str, tuple]:
    """The stacked shape of every kind of leaf: attention and norm leaves
    lead with the layer count, the dense FFN's with the leading dense
    layers', the router's, experts' and shared experts' with the MoE
    layers'."""
    L, D, V = model["n_layers"], model["d_model"], model["vocab_size"]
    H, dn, dr, dv, r = _widths(model)
    Ld = model["first_dense_layers"]
    Lm, E = L - Ld, model["n_experts"]
    Fd, Fe = model["d_ff"], model["moe_d_ff"]
    Fs = Fe * model["n_shared_experts"]
    return {"embedding": (V, D), "final_norm": (D,), "lm_head": (D, V),
            "norm1": (L, D), "norm2": (L, D), "kv_norm": (L, r),
            "wq": (L, D, H * (dn + dr)), "w_kv_a": (L, D, r + dr),
            "w_kv_b": (L, r, H * (dn + dv)), "wo": (L, H * dv, D),
            "w_in": (Ld, D, Fd), "w_gate": (Ld, D, Fd), "w_out": (Ld, Fd, D),
            "router": (Lm, D, E), "router_bias": (Lm, E),
            "we_in": (Lm, E, D, Fe), "we_gate": (Lm, E, D, Fe),
            "we_out": (Lm, E, Fe, D),
            "ws_in": (Lm, D, Fs), "ws_gate": (Lm, D, Fs), "ws_out": (Lm, Fs, D)}


#: the residual branches' output projections, and the matrices that read
#: a branch's input (the router and the head excepted)
OUTPUTS = ("wo", "w_out", "we_out", "ws_out")
INPUTS = ("wq", "w_kv_a", "w_kv_b", "w_in", "w_gate", "we_in", "we_gate",
          "ws_in", "ws_gate")


@torch.no_grad()
def make_weights(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight from ``seed``: one ``randn`` a kind of leaf on the
    device, in the served type, scaled in place to N(0, 1 / fan_in) with
    fan_in a matrix's first dimension (the router's too), the norms' scales
    to N(0, 0.1^2), the correction bias to N(0, ``router_bias_std``^2).
    Where the model gives them, the embedding is N(0, ``embedding_std``^2),
    the residual branches' output projections (``OUTPUTS``) N(0,
    ``residual_out_std``^2) and the matrices that read a branch's input
    (``INPUTS``) N(0, ``input_std``^2) in place of that rule."""
    dtype = DTYPES[model["dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {}
    for name, shape in leaf_shapes(model).items():
        t = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        if name in NORMS:
            std = NORM_SCALE_STD
        elif name == "router_bias":
            std = model["router_bias_std"]
        elif name == "embedding" and "embedding_std" in model:
            std = model["embedding_std"]
        elif name in OUTPUTS and "residual_out_std" in model:
            std = model["residual_out_std"]
        elif name in INPUTS and "input_std" in model:
            std = model["input_std"]
        else:
            std = 1.0 / math.sqrt(shape[-2])
        out[name] = t.mul_(std)
    return out


def port_params(model: dict, w: Dict[str, torch.Tensor]) -> dict:
    """The program's parameter tree over views of ``w``: two groups, the
    leading dense layers and the MoE layers, each layer ``norm1``, ``attn``
    (``wq``, ``w_kv_a``, ``kv_norm``, ``w_kv_b``, ``wo``), ``norm2`` and
    ``ffn`` or ``moe`` (``router``, ``router_bias``, ``we_*``, ``shared``);
    ``final_norm``, ``embedding`` and ``lm_head``."""
    Ld = model["first_dense_layers"]
    layers = []
    for i in range(model["n_layers"]):
        lp = {"norm1": {"scale": w["norm1"][i]},
              "attn": {k: w[k][i] for k in ("wq", "w_kv_a", "kv_norm",
                                            "w_kv_b", "wo")},
              "norm2": {"scale": w["norm2"][i]}}
        if i < Ld:
            lp["ffn"] = {k: w[k][i] for k in ("w_in", "w_gate", "w_out")}
        else:
            j = i - Ld
            lp["moe"] = {k: w[k][j] for k in ("router", "router_bias", "we_in",
                                               "we_gate", "we_out")}
            lp["moe"]["shared"] = {k: w["ws" + k[1:]][j]
                                   for k in ("w_in", "w_gate", "w_out")}
        layers.append(lp)
    return {"groups": [layers[:Ld], layers[Ld:]],
            "final_norm": {"scale": w["final_norm"]},
            "embedding": w["embedding"], "lm_head": w["lm_head"]}


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


def _fp8(w: torch.Tensor) -> torch.Tensor:
    """w [in, out] rounded to float8_e4m3fn with one scale an output
    column, returned in float32."""
    w = w.float()
    scale = w.abs().amax(dim=0, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-halves RoPE of x [S, heads, d] at positions 0..S-1."""
    S, _, d = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=x.device) / d)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: float, act, heads: int = 4) -> torch.Tensor:
    """Causal attention of one sequence: q, k [S, H, dq], v [S, H, dv] ->
    [S, H * dv], ``heads`` heads at a time; ``act`` rounds each product's
    operands (q and k rows, P rows and v rows)."""
    S, H, _ = q.shape
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    out = torch.empty(S, H, v.shape[-1], dtype=torch.float32, device=q.device)
    q, k, v = act(q), act(k), act(v)
    for h0 in range(0, H, heads):
        hs = slice(h0, h0 + heads)
        s = (q[:, hs].transpose(0, 1) @ k[:, hs].permute(1, 2, 0)) * scale
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out[:, hs] = (act(p) @ v[:, hs].transpose(0, 1)).transpose(0, 1)
    return out.reshape(S, -1)


def _fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """x [..., n] rounded to float8_e4m3fn with one scale a row, in
    float32 (a product's input in the control)."""
    scale = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _swiglu(h: torch.Tensor, w_in, w_gate, w_out, act) -> torch.Tensor:
    h = act(h)
    return act(F.silu(h @ w_gate) * (h @ w_in)) @ w_out


def _moe(model: dict, w: Dict[str, torch.Tensor], j: int, h: torch.Tensor,
         widen, act) -> torch.Tensor:
    """MoE layer ``j`` (of the MoE layers) on h [S, D]: the routed experts
    (each one's tokens at a time) plus the shared experts."""
    k = model["experts_per_token"]
    scores = torch.sigmoid(act(h) @ widen(w["router"][j]))
    _, idx = torch.sort(scores + w["router_bias"][j].float(), dim=-1,
                        descending=True, stable=True)
    top = idx[:, :k]
    gates = scores.gather(1, top)
    gates = gates / gates.sum(-1, keepdim=True) * model["moe_routed_scale"]
    out = _swiglu(h, *(widen(w[n][j]) for n in ("ws_in", "ws_gate", "ws_out")),
                  act)
    for e in range(model["n_experts"]):
        tok, slot = (top == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        y = _swiglu(h[tok], *(widen(w[n][j][e])
                              for n in ("we_in", "we_gate", "we_out")), act)
        out.index_add_(0, tok, y * gates[tok, slot, None])
    return out


@torch.no_grad()
def logits(model: dict, w: Dict[str, torch.Tensor],
           sequences: Sequence[torch.Tensor], positions: Sequence[Iterable[int]],
           *, fp8: bool = False) -> List[torch.Tensor]:
    """The logits [len(positions[i]), V] float32 at the positions asked for
    of each token sequence (int64 on the weights' device), by the forward
    pass without a cache (module doc).  ``fp8``: every product computed on
    fp8 operands (the control)."""
    L, D = model["n_layers"], model["d_model"]
    H, dn, dr, dv, r = _widths(model)
    Ld = model["first_dense_layers"]
    theta = float(model["rope_theta"])
    scale = 1.0 / math.sqrt(dn + dr)
    widen = _fp8 if fp8 else (lambda t: t.float())
    act = _fp8_rows if fp8 else (lambda t: t)
    embed_scale = torch.tensor(D ** 0.5, dtype=DTYPES[model["dtype"]]).item()
    with exact_float32():
        xs = [w["embedding"][s].float() * embed_scale for s in sequences]
        for i in range(L):
            wq, w_kv_a, w_kv_b, wo = (widen(w[n][i]) for n in
                                      ("wq", "w_kv_a", "w_kv_b", "wo"))
            for n, x in enumerate(xs):
                S = x.shape[0]
                h = act(_rms(x, w["norm1"][i]))
                q = (h @ wq).view(S, H, dn + dr)
                q = torch.cat([q[..., :dn], _rope(q[..., dn:], theta)], -1)
                kv_a = h @ w_kv_a
                c = _rms(kv_a[:, :r], w["kv_norm"][i])
                k_pe = _rope(kv_a[:, None, r:], theta)
                kv = (act(c) @ w_kv_b).view(S, H, dn + dv)
                k = torch.cat([kv[..., :dn], k_pe.expand(S, H, dr)], -1)
                x = x + act(_attention(q, k, kv[..., dn:], scale, act)) @ wo
                h = _rms(x, w["norm2"][i])
                if i < Ld:
                    xs[n] = x + _swiglu(h, *(widen(w[m][i]) for m in
                                             ("w_in", "w_gate", "w_out")), act)
                else:
                    xs[n] = x + _moe(model, w, i - Ld, h, widen, act)
            del wq, w_kv_a, w_kv_b, wo
        head = widen(w["lm_head"])
        out = []
        for x, pos in zip(xs, positions):
            rows = torch.as_tensor(list(pos), dtype=torch.long, device=x.device)
            out.append(act(_rms(x[rows], w["final_norm"])) @ head)
        return out
