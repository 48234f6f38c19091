"""Model assembly: dense decoder-only LMs built from layer groups.

Parameters are a plain dictionary: ``embedding`` [V,D], ``lm_head`` [D,V]
(absent when tied), ``final_norm`` and ``groups`` — one list per layer group
holding one dictionary per layer (the reference stacks a group's layers on a
leading axis for its scan; here a group is a Python loop over its layers).

Decode state: global-attention groups hold paged KV slabs
``[L, n_frames, bt, K, hd]`` indexed by *physical* frame ids coming from the
block-table translation; local-window groups hold per-sequence rings
``[L, B, W, K, hd]`` that never go through the translation.  ``prefill`` and
``decode_step`` update the caches IN PLACE and return a state that shares
them; a ring is rebuilt (zeroed, then filled) by every prefill.

Ported so far: decoder-only configs with global attention (yi_6b,
qwen3_14b, nemotron_4_15b, chameleon_34b), a local : global layer pattern
(gemma3_4b), or a mixture-of-experts FFN (qwen3_moe_235b_a22b,
kimi_k2_1t_a32b; a layer group's ``moe`` flag picks it).  Anything else
raises NotImplementedError naming its ROADMAP item.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..kvcache.gather import scatter_prefill_plain
from .attention import (attend_causal, attn_decode_paged, attn_decode_ring,
                        attn_forward, init_attn, project_qk_rope_v)
from .common import (SHAPES_ONLY, LayerGroup, ModelConfig, _dense, apply_norm,
                     init_norm, require_ported, rope_tables)
from .ffn import ffn_forward, init_ffn
from .moe import init_moe, moe_forward

PyTree = Any


# --------------------------------------------------------------------------- init
def _init_layer(cfg: ModelConfig, gen: torch.Generator, dtype,
                group: LayerGroup) -> PyTree:
    dev = gen.device
    return {
        "norm1": init_norm(cfg, cfg.d_model, dtype, dev),
        "attn": init_attn(cfg, gen, dtype),
        "norm2": init_norm(cfg, cfg.d_model, dtype, dev),
        **({"moe": init_moe(cfg, gen, dtype)} if group.moe
           else {"ffn": init_ffn(cfg, gen, dtype)}),
    }


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                param_dtype=None) -> PyTree:
    """Random parameters drawn from ``gen``, on the generator's device
    (``torch.Generator(device=...)``), stored as ``param_dtype`` (default
    ``cfg.param_dtype``).  A full-width model stores bfloat16: one cast at
    init gives the values a cast at each use would."""
    dtype = param_dtype or cfg.param_dtype
    groups = require_ported(cfg)
    params: Dict[str, PyTree] = {
        "groups": [[_init_layer(cfg, gen, dtype, g) for _ in range(g.n_layers)]
                   for g in groups],
        "final_norm": init_norm(cfg, cfg.d_model, dtype, gen.device),
        "embedding": _dense(gen, (cfg.vocab_size, cfg.d_model), dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _dense(gen, (cfg.d_model, cfg.vocab_size), dtype)
    return params


def _leaves(tree: PyTree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def param_count(cfg: ModelConfig) -> int:
    """Parameters of ``cfg``, from shapes alone (meta tensors: nothing is
    drawn or allocated)."""
    return sum(t.numel() for t in _leaves(init_params(cfg, SHAPES_ONLY)))


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: the top-k experts only), by the
    reference's formula."""
    total = param_count(cfg)
    if cfg.n_experts == 0:
        return total
    moe_layers = cfg.n_layers - cfg.first_dense_layers
    per_expert = cfg.d_model * cfg.moe_d_ff * (
        3 if cfg.ffn_act in ("silu", "geglu") else 2)
    return total - moe_layers * (cfg.n_experts - cfg.experts_per_token) * per_expert


def params_from_jax(cfg: ModelConfig, tree: PyTree, *,
                    device: DeviceLike = None, param_dtype=None) -> PyTree:
    """The reference's parameter pytree, as numpy arrays, in the port's form.

    ``tree`` has ``embedding``, ``final_norm``, optionally ``lm_head``, and
    ``groups``: one pytree per layer group whose leaves are stacked
    ``[L, ...]``.  Each group is unstacked into a list of per-layer
    dictionaries."""
    device = resolve_device(device)
    dtype = param_dtype or cfg.param_dtype

    def leaf(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=device, dtype=dtype)

    def convert(node, layer: Optional[int] = None):
        if isinstance(node, dict):
            return {k: convert(v, layer) for k, v in node.items()}
        return leaf(node if layer is None else node[layer])

    def n_layers(node) -> int:
        while isinstance(node, dict):
            node = next(iter(node.values()))
        return node.shape[0]

    if len(tree["groups"]) != len(require_ported(cfg)):
        raise ValueError(f"{cfg.name}: {len(tree['groups'])} parameter groups "
                         "do not match the config's layer groups")
    params = {k: convert(v) for k, v in tree.items() if k != "groups"}
    params["groups"] = [[convert(gp, i) for i in range(n_layers(gp))]
                        for gp in tree["groups"]]
    return params


# --------------------------------------------------------------------------- fwd
def _embed(cfg: ModelConfig, params: PyTree, tokens: torch.Tensor
           ) -> torch.Tensor:
    x = params["embedding"][tokens.long()].to(cfg.dtype)
    # gemma-style scale, rounded to the working dtype as the reference does
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype)


def _lm_head(cfg: ModelConfig, params: PyTree, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(cfg, x, params["final_norm"])
    head = params["lm_head"] if "lm_head" in params else params["embedding"].T
    return x @ head.to(cfg.dtype)


def _ffn_block(cfg: ModelConfig, lp: PyTree, x: torch.Tensor
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x + the layer's FFN (dense, or the experts when the layer has
    ``moe``), and the MoE auxiliary loss (None for a dense layer)."""
    h = apply_norm(cfg, x, lp["norm2"])
    if "moe" in lp:
        f, aux = moe_forward(cfg, lp["moe"], h)
        return x + f, aux
    return x + ffn_forward(cfg, lp["ffn"], h), None


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    B, S = tokens.shape
    return torch.arange(S, device=tokens.device)[None, :].expand(B, S)


def forward_lm(cfg: ModelConfig, params: PyTree, tokens: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decoder-only LM forward.  tokens: [B,S] int -> (logits [B,S,V], aux);
    aux is the sum of the MoE layers' auxiliary losses, zero for a dense
    config."""
    groups = require_ported(cfg)
    x = _embed(cfg, params, tokens)
    positions = _positions(tokens)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for g, gp in zip(groups, params["groups"]):
        for lp in gp:
            h = apply_norm(cfg, x, lp["norm1"])
            x = x + attn_forward(cfg, lp["attn"], h, positions,
                                 window=g.window, rope_theta=g.rope_theta)
            x, a = _ffn_block(cfg, lp, x)
            if a is not None:
                aux = aux + a
    return _lm_head(cfg, params, x), aux


# --------------------------------------------------------------------------- decode
class DecodeState(NamedTuple):
    """Per-group caches (tuple indexed like layer_groups(cfg))."""
    caches: Tuple[Dict[str, torch.Tensor], ...]
    seq_lens: torch.Tensor        # [B] tokens so far (incl. prompt), int32


def init_decode_state(cfg: ModelConfig, batch: int, n_blocks: int,
                      max_blocks: int, *, n_pools: int = 1, dtype=None,
                      device: DeviceLike = None) -> DecodeState:
    """n_blocks: physical KV frames in the pool; max_blocks: per-seq table.
    Global groups get paged slabs, windowed groups a ring of ``window``
    slots per sequence.  Both are zeros: a masked slot must hold a finite
    value."""
    if n_pools != 1:
        raise NotImplementedError(
            "pool-partitioned KV slabs are not ported yet "
            "(ROADMAP queue 1 item 13)")
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    hd, K = cfg.resolved_head_dim, cfg.n_kv_heads
    bt = cfg.kv_block_tokens
    caches: List[Dict[str, torch.Tensor]] = []
    for g in require_ported(cfg):
        if g.window is None:
            names, shape = ("k_slabs", "v_slabs"), (g.n_layers, n_blocks, bt, K, hd)
        else:
            names, shape = ("ring_k", "ring_v"), (g.n_layers, batch, g.window, K, hd)
        caches.append({n: torch.zeros(shape, dtype=dtype, device=device)
                       for n in names})
    return DecodeState(tuple(caches),
                       torch.zeros((batch,), dtype=torch.int32, device=device))


def decode_step(cfg: ModelConfig, params: PyTree, state: DecodeState,
                tokens: torch.Tensor, phys_blocks: torch.Tensor
                ) -> Tuple[torch.Tensor, DecodeState]:
    """One token per sequence.  tokens: [B]; phys_blocks: [B, max_blocks]
    int32 physical frame ids from the block-table translation.  The caches of
    ``state`` are written in place.  Returns (logits [B,V], new state)."""
    positions = state.seq_lens                       # position of new token
    x = _embed(cfg, params, tokens)[:, None]
    seq_lens = state.seq_lens + 1
    for g, gp, cache in zip(require_ported(cfg), params["groups"],
                            state.caches):
        x = _decode_group(cfg, g, gp, cache, x, positions, phys_blocks,
                          seq_lens)
    logits = _lm_head(cfg, params, x)[:, 0]
    return logits, DecodeState(state.caches, seq_lens)


def _decode_group(cfg: ModelConfig, g: LayerGroup, gp: PyTree,
                  cache: Dict[str, torch.Tensor], x: torch.Tensor,
                  positions: torch.Tensor, phys_blocks: torch.Tensor,
                  seq_lens: torch.Tensor) -> torch.Tensor:
    rope = rope_tables(positions[:, None], cfg.resolved_head_dim, g.rope_theta)
    for li, lp in enumerate(gp):
        h = apply_norm(cfg, x, lp["norm1"])
        if g.window is None:
            a, _ = attn_decode_paged(
                cfg, lp["attn"], h, positions,
                (cache["k_slabs"][li], cache["v_slabs"][li]), phys_blocks,
                seq_lens, rope=rope)
        else:
            a, _, _ = attn_decode_ring(
                cfg, lp["attn"], h, positions, cache["ring_k"][li],
                cache["ring_v"][li], rope=rope, window=g.window)
        x, _ = _ffn_block(cfg, lp, x + a)
    return x


def prefill(cfg: ModelConfig, params: PyTree, tokens: torch.Tensor,
            state: DecodeState, phys_blocks: torch.Tensor
            ) -> Tuple[torch.Tensor, DecodeState]:
    """Prefill a prompt batch [B,S]: full forward + every layer's K/V into
    the caches of ``state`` (in place): scattered into the slabs through the
    block table, or the last ``min(S, W)`` tokens into a ring rebuilt from
    zeros.  Returns (logits of the last position [B,V], new state)."""
    B, S = tokens.shape
    x = _embed(cfg, params, tokens)
    positions = _positions(tokens)
    for g, gp, cache in zip(require_ported(cfg), params["groups"],
                            state.caches):
        x = _prefill_group(cfg, g, gp, cache, x, positions, phys_blocks)
    logits = _lm_head(cfg, params, x[:, -1])
    seq_lens = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    return logits, DecodeState(state.caches, seq_lens)


def _prefill_group(cfg: ModelConfig, g: LayerGroup, gp: PyTree,
                   cache: Dict[str, torch.Tensor], x: torch.Tensor,
                   positions: torch.Tensor, phys_blocks: torch.Tensor
                   ) -> torch.Tensor:
    """Forward one group over the full prompt and fill its caches."""
    bt = cfg.kv_block_tokens
    S = x.shape[1]
    rope = rope_tables(positions, cfg.resolved_head_dim, g.rope_theta)
    for li, lp in enumerate(gp):
        h = apply_norm(cfg, x, lp["norm1"])
        q, k, v = project_qk_rope_v(cfg, lp["attn"], h, rope)
        a = attend_causal(cfg, lp["attn"], q, k, v, window=g.window)
        if g.window is None:
            # scatter this layer's K/V into the paged slabs
            scatter_prefill_plain(cache["k_slabs"][li], cache["v_slabs"][li],
                                  k, v, phys_blocks, positions, bt)
        else:
            # rebuild the ring: the state is shared by every wave (and the
            # warm-up), so the slots this prompt does not fill must not keep
            # an earlier wave's keys
            W = g.window
            src = torch.arange(max(S - W, 0), S, device=x.device)
            for name, t in (("ring_k", k), ("ring_v", v)):
                ring = cache[name][li]
                ring.zero_()
                ring[:, src % W] = t[:, src].to(ring.dtype)
        x, _ = _ffn_block(cfg, lp, x + a)
    return x


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)
