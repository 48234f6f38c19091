"""Model assembly: decoder-only LMs (dense, MoE, SSM, hybrid) and the
Whisper-style encoder-decoder, built from layer groups.

Parameters are a plain dictionary: ``embedding`` [V,D] (an encoder-decoder
has ``dec_embedding``, ``dec_pos`` and ``enc_norm`` instead), ``lm_head``
[D,V] (absent when tied), ``final_norm`` and ``groups`` — one list per layer
group holding one dictionary per layer (the reference stacks a group's
layers on a leading axis for its scan; here a group is a Python loop over
its layers).

Decode state: global-attention groups hold paged KV slabs
``[L, n_frames, bt, K, hd]`` indexed by *physical* frame ids coming from the
block-table translation; local-window groups hold per-sequence rings
``[L, B, W, K, hd]`` that never go through the translation; SSD and RG-LRU
groups hold a float32 recurrent state ``h`` and a conv tail; a decoder group
holds its cross K/V ``[L, B, Se, K, hd]`` beside its slabs.  ``prefill``,
``prefill_encdec`` and ``decode_step`` update the caches IN PLACE and return
a state that shares them; every prefill rewrites a ring or a recurrent
state whole.

Every arch of the reference is ported; only ``attn_logit_softcap``, which no
config sets, raises NotImplementedError naming its ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from .._tree import tree_leaves
from ..kvcache.gather import scatter_prefill_plain
from .attention import (attend, attn_decode_paged, attn_decode_ring,
                        cross_attention, cross_kv, init_attn,
                        project_qk_rope_v, rope_for)
from .common import (SHAPES_ONLY, LayerGroup, ModelConfig, _dense, apply_norm,
                     init_norm, require_ported)
from .ffn import ffn_forward, init_ffn
from .moe import init_moe, moe_forward
from .rglru import init_rglru, rglru_decode, rglru_forward
from .ssm import init_ssd, ssd_decode, ssd_forward

PyTree = Any


# --------------------------------------------------------------------------- init
def _init_layer(cfg: ModelConfig, gen: torch.Generator, dtype,
                group: LayerGroup) -> PyTree:
    """One layer of ``group``: attention (self, and cross for a decoder
    layer), RG-LRU or SSD mixer, then an FFN (none for an SSD layer), each
    behind its norm, as the reference builds it."""
    dev = gen.device
    p: Dict[str, PyTree] = {"norm1": init_norm(cfg, cfg.d_model, dtype, dev)}
    if group.kind == "ssd":
        p["ssd"] = init_ssd(cfg, gen, dtype)
        return p
    if group.kind == "rglru":
        p["rglru"] = init_rglru(cfg, gen, dtype)
    else:
        p["attn"] = init_attn(cfg, gen, dtype)
    p["norm2"] = init_norm(cfg, cfg.d_model, dtype, dev)
    if group.kind == "dec_attn":
        p["cross"] = init_attn(cfg, gen, dtype, cross=True)
        p["norm_cross"] = init_norm(cfg, cfg.d_model, dtype, dev)
    if group.moe:
        p["moe"] = init_moe(cfg, gen, dtype)
    else:
        p["ffn"] = init_ffn(cfg, gen, dtype)
    return p


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
    }
    if cfg.family == "encdec":
        params["dec_pos"] = _dense(gen, (cfg.max_decoder_len, cfg.d_model),
                                   dtype, scale=0.02)
        params["dec_embedding"] = _dense(gen, (cfg.vocab_size, cfg.d_model),
                                         dtype)
        params["enc_norm"] = init_norm(cfg, cfg.d_model, dtype, gen.device)
    else:
        params["embedding"] = _dense(gen, (cfg.vocab_size, cfg.d_model), dtype)
    if not cfg.tie_embeddings:
        params["lm_head"] = _dense(gen, (cfg.d_model, cfg.vocab_size), dtype)
    return params


def param_count(cfg: ModelConfig) -> int:
    """Parameters of ``cfg``, from shapes alone (meta tensors: nothing is
    drawn or allocated)."""
    return sum(t.numel() for t in tree_leaves(init_params(cfg, SHAPES_ONLY)))


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
ATTN_KINDS = ("attn", "enc_attn", "dec_attn")


def _embed(cfg: ModelConfig, params: PyTree, tokens: torch.Tensor
           ) -> torch.Tensor:
    if cfg.family == "encdec":
        raise ValueError(f"{cfg.name}: an encoder-decoder config runs through "
                         "forward_encdec / prefill_encdec")
    x = params["embedding"][tokens.long()].to(cfg.dtype)
    # gemma-style scale, rounded to the working dtype as the reference does
    # (for every decoder-only family, Mamba-2's included)
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype)


def _dec_embed(cfg: ModelConfig, params: PyTree, tokens: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """The encoder-decoder's decoder input: token embedding plus the learned
    position embedding (clipped to ``max_decoder_len``), no scale."""
    x = params["dec_embedding"][tokens.long()].to(cfg.dtype)
    pos = positions.long().clamp(0, cfg.max_decoder_len - 1)
    return x + params["dec_pos"][pos].to(cfg.dtype)


def _lm_head(cfg: ModelConfig, params: PyTree, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(cfg, x, params["final_norm"])
    if "lm_head" in params:
        head = params["lm_head"]
    else:
        head = params["dec_embedding" if cfg.family == "encdec"
                      else "embedding"].T
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


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None, :].expand(B, S)


def _store_state(cache: Dict[str, torch.Tensor], li: int,
                 state: Dict[str, torch.Tensor]) -> None:
    """Write a recurrent layer's state into layer ``li`` of its group's
    cache, in place (one state serves every wave and the warm-up)."""
    for name, t in state.items():
        cache[name][li].copy_(t)


def _store_kv(cfg: ModelConfig, g: LayerGroup, cache: Dict[str, torch.Tensor],
              li: int, k: torch.Tensor, v: torch.Tensor,
              positions: torch.Tensor, phys_blocks: torch.Tensor) -> None:
    """A prompt's self-attention K/V into layer ``li``'s cache: scattered
    into the paged slabs through the block table, or the last ``min(S, W)``
    tokens into a ring rebuilt from zeros (the state is shared by every wave
    and the warm-up, so the slots this prompt does not fill must not keep an
    earlier wave's keys)."""
    if "k_slabs" in cache:
        scatter_prefill_plain(cache["k_slabs"][li], cache["v_slabs"][li],
                              k, v, phys_blocks, positions, cfg.kv_block_tokens)
        return
    W, S = g.window, k.shape[1]
    src = torch.arange(max(S - W, 0), S, device=k.device)
    for name, t in (("ring_k", k), ("ring_v", v)):
        ring = cache[name][li]
        ring.zero_()
        ring[:, src % W] = t[:, src].to(ring.dtype)


def _run_group(cfg: ModelConfig, g: LayerGroup, gp: PyTree, x: torch.Tensor,
               positions: torch.Tensor, *,
               cache: Optional[Dict[str, torch.Tensor]] = None,
               phys_blocks: Optional[torch.Tensor] = None,
               enc_out: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One layer group over a whole sequence x [B,S,D]: (x, the summed MoE
    aux loss or None).  With ``cache`` (the group's decode state) every
    layer also fills its part of it, in place: self-attention K/V
    (``_store_kv``), the SSD / RG-LRU state, and a decoder layer reads its
    cross K/V from it; without, a decoder layer projects ``enc_out``."""
    rope = (rope_for(cfg, positions, g.rope_theta) if g.kind in ATTN_KINDS
            else None)
    aux: Optional[torch.Tensor] = None
    for li, lp in enumerate(gp):
        h = apply_norm(cfg, x, lp["norm1"])
        if g.kind in ("ssd", "rglru"):
            fwd = ssd_forward if g.kind == "ssd" else rglru_forward
            if cache is None:
                out = fwd(cfg, lp[g.kind], h)
            else:
                out, state = fwd(cfg, lp[g.kind], h, return_state=True)
                _store_state(cache, li, state)
            x = x + out
            if g.kind == "ssd":             # an SSD layer has no FFN
                continue
        else:
            q, k, v = project_qk_rope_v(cfg, lp["attn"], h, rope)
            a = attend(cfg, lp["attn"], q, k, v, causal=g.kind != "enc_attn",
                       window=g.window)
            if cache is not None:
                _store_kv(cfg, g, cache, li, k, v, positions, phys_blocks)
            x = x + a
            if g.kind == "dec_attn":
                ck, cv = ((cache["cross_k"][li], cache["cross_v"][li])
                          if cache is not None
                          else cross_kv(cfg, lp["cross"], enc_out))
                h = apply_norm(cfg, x, lp["norm_cross"])
                x = x + cross_attention(cfg, lp["cross"], h, ck, cv)
        x, a = _ffn_block(cfg, lp, x)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def forward_lm(cfg: ModelConfig, params: PyTree, tokens: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decoder-only LM forward.  tokens: [B,S] int -> (logits [B,S,V], aux);
    aux is the sum of the MoE layers' auxiliary losses, zero for a dense
    config."""
    groups = require_ported(cfg)
    x = _embed(cfg, params, tokens)
    positions = _positions(*tokens.shape, tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for g, gp in zip(groups, params["groups"]):
        x, a = _run_group(cfg, g, gp, x, positions)
        if a is not None:
            aux = aux + a
    return _lm_head(cfg, params, x), aux


# --------------------------------------------------------------------------- enc-dec
def _sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """[length, channels] float32: sin then cos of position / 10000^(i/(c/2-1))."""
    log_timescale = (torch.log(torch.tensor(10_000.0, device=device))
                     / (channels // 2 - 1))
    inv = torch.exp(-log_timescale * torch.arange(channels // 2, device=device))
    scaled = torch.arange(length, device=device)[:, None].float() * inv[None]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


def _round_weights(tree: PyTree, dtype) -> PyTree:
    """Every matrix of ``tree`` rounded to ``dtype`` and held as float32;
    vectors (norms, biases) as they are."""
    if isinstance(tree, dict):
        return {k: _round_weights(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_round_weights(v, dtype) for v in tree]
    return tree.to(dtype).float() if tree.dim() >= 2 else tree


def _encode(cfg: ModelConfig, params: PyTree, enc_feats: torch.Tensor
            ) -> torch.Tensor:
    """The encoder over frame embeddings enc_feats [B,Se,D] (the audio
    frontend is a stub, as in the reference) -> enc_out [B,Se,D] float32.

    The reference adds float32 sinusoids to the frames in ``cfg.dtype``, and
    its type promotion then carries the whole encoder in float32, each
    product on weights rounded to ``cfg.dtype``.  The port computes the
    same: the encoder's layers under a float32 config, on its matrices
    rounded once."""
    B, Se, _ = enc_feats.shape
    g = require_ported(cfg)[0]
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    x = (enc_feats.to(cfg.dtype).float()
         + _sinusoids(Se, cfg.d_model, enc_feats.device)[None])
    x, _ = _run_group(cfg32, g, _round_weights(params["groups"][0], cfg.dtype),
                      x, _positions(B, Se, x.device))
    return apply_norm(cfg32, x, params["enc_norm"])


def forward_encdec(cfg: ModelConfig, params: PyTree, enc_feats: torch.Tensor,
                   dec_tokens: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whisper-style: enc_feats [B,Se,D] (frontend stub), dec_tokens [B,Sd]
    -> (logits [B,Sd,V], aux (zero: no MoE))."""
    dec_g = require_ported(cfg)[1]
    enc_out = _encode(cfg, params, enc_feats)
    positions = _positions(*dec_tokens.shape, dec_tokens.device)
    y = _dec_embed(cfg, params, dec_tokens, positions)
    y, _ = _run_group(cfg, dec_g, params["groups"][1], y, positions,
                      enc_out=enc_out)
    return (_lm_head(cfg, params, y),
            torch.zeros((), dtype=torch.float32, device=y.device))


def prefill_encdec(cfg: ModelConfig, params: PyTree, enc_feats: torch.Tensor,
                   dec_tokens: torch.Tensor, state: "DecodeState",
                   phys_blocks: torch.Tensor
                   ) -> Tuple[torch.Tensor, "DecodeState"]:
    """Whisper-style prefill: run the encoder, fill each decoder layer's
    cross K/V from its output, then prefill the decoder prompt [B,Sd] (its
    self-attention K/V scattered into the paged slabs through the block
    table).  The caches of ``state`` (made with ``enc_len`` = Se) are
    written in place.  Returns (logits of the last position [B,V], state)."""
    dec_g = require_ported(cfg)[1]
    dec_cache, dp = state.caches[1], params["groups"][1]
    enc_out = _encode(cfg, params, enc_feats)
    for li, lp in enumerate(dp):
        ck, cv = cross_kv(cfg, lp["cross"], enc_out)
        dec_cache["cross_k"][li].copy_(ck)
        dec_cache["cross_v"][li].copy_(cv)
    B, Sd = dec_tokens.shape
    positions = _positions(B, Sd, dec_tokens.device)
    y = _dec_embed(cfg, params, dec_tokens, positions)
    y, _ = _run_group(cfg, dec_g, dp, y, positions, cache=dec_cache,
                      phys_blocks=phys_blocks)
    logits = _lm_head(cfg, params, y[:, -1])
    seq_lens = torch.full((B,), Sd, dtype=torch.int32, device=y.device)
    return logits, DecodeState(state.caches, seq_lens)


def lm_loss(cfg: ModelConfig, params: PyTree, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy on a float32 log-softmax, plus 0.01 times
    the MoE aux loss.  batch: ``tokens`` [B,S+1] (and ``enc_feats`` [B,Se,D]
    for an encoder-decoder), optionally ``mask`` [B,S+1] (position 0 is
    dropped with the inputs).  Returns (total, {loss, aux, tokens})."""
    tokens = batch["tokens"]
    if cfg.family == "encdec":
        logits, aux = forward_encdec(cfg, params, batch["enc_feats"],
                                     tokens[:, :-1])
    else:
        logits, aux = forward_lm(cfg, params, tokens[:, :-1])
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, targets[..., None])[..., 0]
    mask = batch.get("mask")
    if mask is not None:
        mask = mask[:, 1:].to(torch.float32)
        loss = -(ll * mask).sum() / mask.sum().clamp_min(1.0)
    else:
        loss = -ll.mean()
    total = loss + 0.01 * aux
    return total, {"loss": loss, "aux": aux,
                   "tokens": torch.tensor(float(targets.numel()),
                                          device=loss.device)}


# --------------------------------------------------------------------------- decode
class DecodeState(NamedTuple):
    """Per-group caches (tuple indexed like layer_groups(cfg))."""
    caches: Tuple[Dict[str, torch.Tensor], ...]
    seq_lens: torch.Tensor        # [B] tokens so far (incl. prompt), int32


def init_decode_state(cfg: ModelConfig, batch: int, n_blocks: int,
                      max_blocks: int, *, enc_len: int = 0, n_pools: int = 1,
                      dtype=None, device: DeviceLike = None) -> DecodeState:
    """n_blocks: physical KV frames in the pool; max_blocks: per-seq table;
    enc_len: encoder frames (the cross K/V of an encoder-decoder).  Global
    attention groups get paged slabs, windowed groups a ring of ``window``
    slots per sequence, SSD and RG-LRU groups a float32 state ``h`` and a
    conv tail, the encoder nothing.  All zeros: a masked slot must hold a
    finite value."""
    if n_pools != 1:
        raise NotImplementedError(
            "pool-partitioned KV slabs are not ported yet "
            "(ROADMAP queue 1 item 13)")
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    hd, K = cfg.resolved_head_dim, cfg.n_kv_heads
    bt, W1 = cfg.kv_block_tokens, cfg.conv_width - 1
    caches: List[Dict[str, torch.Tensor]] = []
    for g in require_ported(cfg):
        L = g.n_layers
        shapes: Dict[str, Tuple[Tuple[int, ...], Any]] = {}
        if g.kind == "ssd":
            shapes = {"h": ((L, batch, cfg.ssm_n_heads, cfg.ssm_state,
                             cfg.ssm_head_dim), torch.float32),
                      "conv": ((L, batch, W1, cfg.d_inner + 2 * cfg.ssm_state),
                               dtype)}
        elif g.kind == "rglru":
            w = cfg.lru_width or cfg.d_model
            shapes = {"h": ((L, batch, w), torch.float32),
                      "conv": ((L, batch, W1, w), dtype)}
        elif g.kind in ("attn", "dec_attn") and g.window is None:
            shapes = {n: ((L, n_blocks, bt, K, hd), dtype)
                      for n in ("k_slabs", "v_slabs")}
            if g.kind == "dec_attn":
                shapes.update({n: ((L, batch, enc_len, K, hd), dtype)
                               for n in ("cross_k", "cross_v")})
        elif g.kind == "attn":
            shapes = {n: ((L, batch, g.window, K, hd), dtype)
                      for n in ("ring_k", "ring_v")}
        caches.append({n: torch.zeros(shape, dtype=dt, device=device)
                       for n, (shape, dt) in shapes.items()})
    return DecodeState(tuple(caches),
                       torch.zeros((batch,), dtype=torch.int32, device=device))


def decode_step(cfg: ModelConfig, params: PyTree, state: DecodeState,
                tokens: torch.Tensor, phys_blocks: torch.Tensor
                ) -> Tuple[torch.Tensor, DecodeState]:
    """One token per sequence.  tokens: [B]; phys_blocks: [B, max_blocks]
    int32 physical frame ids from the block-table translation.  The caches of
    ``state`` are written in place.  Returns (logits [B,V], new state)."""
    positions = state.seq_lens                       # position of new token
    if cfg.family == "encdec":
        x = _dec_embed(cfg, params, tokens[:, None], positions[:, None])
    else:
        x = _embed(cfg, params, tokens)[:, None]
    seq_lens = state.seq_lens + 1
    for g, gp, cache in zip(require_ported(cfg), params["groups"],
                            state.caches):
        if g.kind == "enc_attn":                    # no decode state
            continue
        x = _decode_group(cfg, g, gp, cache, x, positions, phys_blocks,
                          seq_lens)
    logits = _lm_head(cfg, params, x)[:, 0]
    return logits, DecodeState(state.caches, seq_lens)


def _decode_group(cfg: ModelConfig, g: LayerGroup, gp: PyTree,
                  cache: Dict[str, torch.Tensor], x: torch.Tensor,
                  positions: torch.Tensor, phys_blocks: torch.Tensor,
                  seq_lens: torch.Tensor) -> torch.Tensor:
    rope = (rope_for(cfg, positions[:, None], g.rope_theta)
            if g.kind in ATTN_KINDS else None)
    for li, lp in enumerate(gp):
        h = apply_norm(cfg, x, lp["norm1"])
        if g.kind in ("ssd", "rglru"):
            step = ssd_decode if g.kind == "ssd" else rglru_decode
            a, hs, conv = step(cfg, lp[g.kind], h, cache["h"][li],
                               cache["conv"][li])
            _store_state(cache, li, {"h": hs, "conv": conv})
            if g.kind == "ssd":             # an SSD layer has no FFN
                x = x + a
                continue
        elif g.window is None:
            a, _ = attn_decode_paged(
                cfg, lp["attn"], h, positions,
                (cache["k_slabs"][li], cache["v_slabs"][li]), phys_blocks,
                seq_lens, rope=rope)
        else:
            a, _, _ = attn_decode_ring(
                cfg, lp["attn"], h, positions, cache["ring_k"][li],
                cache["ring_v"][li], rope=rope, window=g.window)
        x = x + a
        if g.kind == "dec_attn":
            h = apply_norm(cfg, x, lp["norm_cross"])
            x = x + cross_attention(cfg, lp["cross"], h, cache["cross_k"][li],
                                    cache["cross_v"][li])
        x, _ = _ffn_block(cfg, lp, x)
    return x


def prefill(cfg: ModelConfig, params: PyTree, tokens: torch.Tensor,
            state: DecodeState, phys_blocks: torch.Tensor
            ) -> Tuple[torch.Tensor, DecodeState]:
    """Prefill a prompt batch [B,S]: full forward + every layer's state into
    the caches of ``state`` (in place): K/V scattered into the slabs through
    the block table, or the last ``min(S, W)`` tokens into a ring rebuilt
    from zeros, or the SSD / RG-LRU state after the prompt.  Returns (logits
    of the last position [B,V], new state)."""
    B, S = tokens.shape
    x = _embed(cfg, params, tokens)
    positions = _positions(B, S, tokens.device)
    for g, gp, cache in zip(require_ported(cfg), params["groups"],
                            state.caches):
        x, _ = _run_group(cfg, g, gp, x, positions, cache=cache,
                          phys_blocks=phys_blocks)
    logits = _lm_head(cfg, params, x[:, -1])
    seq_lens = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    return logits, DecodeState(state.caches, seq_lens)


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)
