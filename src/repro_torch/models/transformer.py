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

Every arch of the reference is ported, and so is its logit soft-cap
(``attn_logit_softcap``, on every attention path: ``attention.py``).

Training rematerialises each layer by default, as the reference does
(``forward_lm`` / ``forward_encdec`` / ``lm_loss(remat=True)``; ``"full"`` or
``"dots"``, ``_run_group``): a forward that autograd records runs each layer
(``_layer``) under non-reentrant ``torch.utils.checkpoint``, and the backward
runs it again, its K2 launches (with the LSE) and model-axis collectives
included.  A prefill or a decode step is never wrapped.

Over the grid's ``model`` axis (``tp``: a ``Pods``, tensor parallelism; the
parameters from ``launch/specs.py:shard_params``, a split leaf carrying a
leading local-shard dimension) every family runs as the reference's rules
place it, each layer by what its leaves say is split: attention by heads
(global, windowed, the encoder's, the decoder's self- and
cross-attention), the dense FFN by ``ff`` (``attention.py`` / ``ffn.py``),
the MoE experts by expert (``moe.py``), the SSD by head and the RG-LRU by
channel (``ssm.py`` / ``rglru.py``); a layer whose leaves are whole runs
replicated, once.  The embedding is vocab-parallel (each shard looks up the
ids in its range, the others' rows are exact zeros, and the sum over the
axis equals the unsharded lookup bit for bit) and so is the head (each
shard's logits ``[p, ..., V/t]``; ``lm_loss`` builds the log-softmax from
``pmax`` and ``psum`` of the local logits, and ``greedy_sample`` picks
across the shards, so the whole ``[.., V]`` is never gathered); the
encoder-decoder's ``dec_embedding`` stays whole.  Decode reads the paged
slabs (pooled or not), the rings and the cross K/V replicated (each shard
its kv heads) or split ``[L, t, ..., K/t, hd]``
(``init_decode_state(kv_split=t)``), and the recurrent states per shard
(``state_split=t``), as the state's ``CacheLayout`` records; under
sequence-parallel decode each shard attends its heads over the pools.
Without ``tp``, or with an axis of size 1, every path is the one above.

Megatron sequence parallelism (the rules in force put ``act_seq`` on
``model``, as ``specs.make_rules`` does for ``PerfOptions(seq_parallel=True)``
and the reference's option does; a model axis of t > 1; ``SeqParallel``):
between blocks the residual stream is each shard's
S / t rows, stacked ``[p, B, S/t, D]``, and every residual block
(``_block``: a layer's attention or recurrent mixer, cross-attention, FFN
or experts, each behind its own norm) runs its norm on the shard's rows,
gathers them along the sequence (``all_gather_dim``) in place of
``tp.copy_in`` and reduce-scatters its output (``SeqParallel.block_out``)
in place of the block's ``tp.psum``; inside a block
nothing changes (the MoE routes the gathered tokens).  A block whose
leaves are whole runs replicated on the gathered rows and keeps its
shard's chunk of the output.  The vocab-parallel embedding's psum becomes
a reduce-scatter (a whole embedding: its chunk), the head gathers the
final norm's rows (a prefill: only each shard's last row), and the norms'
scales sum their gradients over the axis (``sum_grads``).  A stack whose
length t does not divide (a decode step, Whisper's 1 500 frames at t = 16)
runs without it, as the reference's ``_divisible`` drops such a split; the
same kernels launch either way.  On ``LoopPods`` the shards' rows are
chunks of one buffer and the norms run over all of them at once, so the
forward, the loss and every gradient are bit for bit those without.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from .. import tracing
from .._device import DeviceLike, resolve_device
from .._tree import tree_leaves
from ..distributed.pods import Pods
from ..distributed.sharding import current_rules
from ..kvcache.gather import (scatter_latent, scatter_prefill_plain,
                              scatter_prefill_pooled)
from .attention import (ShardHeads, _kv_of, attend, attend_tp,
                        attn_decode_mla, attn_decode_paged,
                        attn_decode_paged_tp, attn_decode_ring,
                        attn_decode_ring_tp, cross_attention,
                        cross_attention_tp, cross_kv, cross_kv_tp,
                        heads_sharded, init_attn, init_mla, mla_attend,
                        project_qk_rope_v, rope_for)
from .common import (SHAPES_ONLY, CacheLayout, LayerGroup, ModelConfig,
                     _dense, apply_norm, init_norm, require_ported, rms_norm)
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
        p["attn"] = (init_mla if cfg.mla else init_attn)(cfg, gen, dtype)
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


def model_axis(tp: Optional[Pods]) -> Optional[Pods]:
    """``tp`` when it splits the model (size > 1), else None."""
    return None if tp is None or tp.n == 1 else tp


class SeqParallel:
    """Megatron sequence parallelism over the model axis ``tp`` for one
    stack of rows (module doc): the residual stream is each local shard's
    chunk of the sequence, ``[p, B, S/t, D]``.  It is also the axis as a
    split block sees it: the block's input arrives gathered (``gather``),
    so ``block_in`` hands each local shard a copy without a collective,
    ``block_out`` reduce-scatters the partial outputs along the sequence
    and ``block_extra`` takes each shard's chunk of a replicated term;
    every other collective is ``tp``'s."""

    def __init__(self, tp: Pods):
        self.tp = tp

    def __getattr__(self, name):
        return getattr(self.tp, name)

    def block_in(self, x: torch.Tensor) -> torch.Tensor:
        return x.unsqueeze(0).expand(self.tp.local, *x.shape)

    def block_out(self, parts: torch.Tensor) -> torch.Tensor:
        return self.tp.reduce_scatter(parts, 1)

    def block_extra(self, x: torch.Tensor) -> torch.Tensor:
        return self.tp.scatter_dim(x, 1)

    def norm(self, cfg: ModelConfig, x: torch.Tensor,
             p: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The norm of the shards' rows x [p, B, S/t, D], all of this
        process's at once; the scales' gradients summed over the axis.  The
        RMSNorm runs on the stack as it is (its composite backward adds its
        terms into x's gradient as it does without the split); the
        LayerNorm's native kernel reads contiguous rows, so it gets them
        joined in sequence order (its scale's and bias's gradients then sum
        the rows in the order they do without the split)."""
        w = {k: self.tp.sum_grads(v) for k, v in p.items()}
        if cfg.norm != "layernorm":
            return apply_norm(cfg, x, w)
        return Pods._chunks(apply_norm(cfg, Pods._joined(x, 1), w),
                            self.tp.local, 1)

    def gather(self, h: torch.Tensor, partial: bool = True) -> torch.Tensor:
        """The whole stack [B, S, D] from the shards' rows (``partial``: the
        readers are the shards' own work, whose gradients sum)."""
        return self.tp.all_gather_dim(h, 1, partial=partial)

    def last_rows(self, x: torch.Tensor) -> torch.Tensor:
        """x[:, -1] of the whole stack [B, D]: each shard's last row
        gathered, the last shard's kept."""
        return self.tp.all_gather_dim(x[:, :, -1:], 1, partial=False)[:, -1]


def seq_splits(t: int, length: int, seq_parallel: bool) -> bool:
    """Whether sequence parallelism splits a stack of ``length`` rows over
    a model axis of t: on, t > 1 and t dividing the rows."""
    return seq_parallel and t > 1 and length % t == 0


def seq_shards(tp: Optional[Pods], length: int) -> Optional[SeqParallel]:
    """Sequence parallelism for a stack of ``length`` rows over ``tp``, or
    None where it does not split: the rules in force keep ``act_seq`` off
    the model axis, or ``seq_splits`` says no."""
    on = current_rules().lookup("act_seq") == "model"
    if tp is None or not seq_splits(tp.n, length, on):
        return None
    return SeqParallel(tp)


def _norm(cfg: ModelConfig, x: torch.Tensor, p: Dict[str, torch.Tensor]
          ) -> torch.Tensor:
    """``apply_norm`` in ``cfg.dtype``: a float32 residual stream
    (``cfg.f32_residual``) is normed into the working type."""
    return apply_norm(cfg, x, p).to(cfg.dtype)


def _block(cfg: ModelConfig, x: torch.Tensor, norm: Dict[str, torch.Tensor],
           fn, tp: Optional[Pods], seq: Optional[SeqParallel], split: bool):
    """One residual block, ``x + fn(norm(x), axis)``: (x, fn's second
    output).  Without ``seq`` as the layers always ran; with it the rows are
    gathered for ``fn``, and a ``split`` block (whose leaves are split over
    the axis, so ``fn`` ends in ``block_out``) reduce-scatters its output
    through ``seq``, a replicated one keeps its shard's chunk."""
    if seq is None:
        out, extra = fn(_norm(cfg, x, norm), tp)
        return x + out, extra
    h = seq.norm(cfg, x, norm)
    if split:
        out, extra = fn(seq.gather(h), seq)
    else:
        out, extra = fn(seq.gather(h, partial=False), seq.tp)
        out = seq.tp.scatter_dim(out, 1)
    if out.shape != x.shape:
        raise RuntimeError(f"a sequence-parallel block returned "
                           f"{tuple(out.shape)} for rows {tuple(x.shape)}")
    return x + out, extra


def _embed(cfg: ModelConfig, params: PyTree, tokens: torch.Tensor,
           tp: Optional[Pods] = None,
           seq: Optional[SeqParallel] = None) -> torch.Tensor:
    if cfg.family == "encdec":
        raise ValueError(f"{cfg.name}: an encoder-decoder config runs through "
                         "forward_encdec / prefill_encdec")
    emb = params["embedding"]
    if tp is not None and emb.dim() == 3:
        # vocab-parallel: each shard's rows, exact zeros outside its range
        ids, Vs = tokens.long(), emb.shape[1]
        parts = []
        for i, shard in enumerate(tp.local_indices()):
            local = ids - shard * Vs
            rows = emb[i][local.clamp(0, Vs - 1)].to(cfg.dtype)
            inside = ((local >= 0) & (local < Vs))[..., None]
            parts.append(torch.where(inside, rows, torch.zeros_like(rows)))
        x = (tp.psum(torch.stack(parts))[0] if seq is None
             else tp.reduce_scatter(torch.stack(parts), 1))
    else:
        x = emb[tokens.long()].to(cfg.dtype)
        if seq is not None:
            x = seq.tp.scatter_dim(x, 1)
    # gemma-style scale, rounded to the working dtype as the reference does
    # (for every decoder-only family, Mamba-2's included); a float32
    # residual stream takes the product in float32
    scale = torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype)
    if cfg.f32_residual:
        return x.float() * scale.float()
    return x * scale


def _dec_embed(cfg: ModelConfig, params: PyTree, tokens: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """The encoder-decoder's decoder input: token embedding plus the learned
    position embedding (clipped to ``max_decoder_len``), no scale."""
    x = params["dec_embedding"][tokens.long()].to(cfg.dtype)
    pos = positions.long().clamp(0, cfg.max_decoder_len - 1)
    return x + params["dec_pos"][pos].to(cfg.dtype)


def _lm_head(cfg: ModelConfig, params: PyTree, x: torch.Tensor,
             tp: Optional[Pods] = None,
             seq: Optional[SeqParallel] = None) -> torch.Tensor:
    """Logits [..., V]; over a vocab-split model axis each local shard's
    [p, ..., V/t].  ``seq``: x is the shards' rows, gathered after the
    final norm."""
    if "lm_head" in params:
        head = params["lm_head"]
    else:
        head = params["dec_embedding" if cfg.family == "encdec"
                      else "embedding"].transpose(-1, -2)
    split = tp is not None and head.dim() == 3
    if seq is None:
        x = _norm(cfg, x, params["final_norm"])
        xin = tp.copy_in(x) if split else None
    else:
        x = seq.gather(seq.norm(cfg, x, params["final_norm"]), partial=split)
        xin = seq.block_in(x) if split else None
    if split:
        return torch.stack([xin[i] @ head[i].to(cfg.dtype)
                            for i in range(tp.local)])
    return x @ head.to(cfg.dtype)


def vocab_split(params: PyTree) -> bool:
    """Whether the head's logits come as vocab shards [p, ..., V/t] (never
    for an encoder-decoder: ``dec_embedding`` has no split in the rules)."""
    head = params.get("lm_head", params.get("embedding"))
    return head is not None and head.dim() == 3


def gather_vocab(logits: torch.Tensor, tp: Pods) -> torch.Tensor:
    """Vocab shards [p, ..., V/t] -> the whole logits [..., V] (an
    all-gather over the model axis)."""
    whole = tp.all_gather(logits)[0]                 # [n, ..., V/t]
    return whole.movedim(0, -2).flatten(-2)


def _ffn_block(cfg: ModelConfig, lp: PyTree, x: torch.Tensor,
               tp: Optional[Pods] = None, seq: Optional[SeqParallel] = None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x + the layer's FFN (dense, or the experts when the layer has
    ``moe``), and the MoE auxiliary loss (None for a dense layer)."""
    if "moe" in lp:
        split = tp is not None and lp["moe"]["we_in"].dim() == 4
        if cfg.f32_residual and seq is None and not split:
            # the router reads the float32 residual's norm unrounded
            out, aux = moe_forward(cfg, lp["moe"],
                                   rms_norm(x, lp["norm2"]["scale"]), tp)
            return x + out, aux
        return _block(cfg, x, lp["norm2"],
                      lambda h, ax: moe_forward(cfg, lp["moe"], h, ax),
                      tp, seq, split)
    split = tp is not None and lp["ffn"]["w_in"].dim() == 3
    return _block(cfg, x, lp["norm2"],
                  lambda h, ax: (ffn_forward(cfg, lp["ffn"], h, ax), None),
                  tp, seq, split)


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
              positions: torch.Tensor, phys_blocks: torch.Tensor,
              layout: CacheLayout) -> None:
    """A prompt's self-attention K/V into layer ``li``'s cache: scattered
    into the paged slabs through the block table (``layout.pools``: the
    row's pool), or the last ``min(S, W)`` tokens into a ring rebuilt from
    zeros (the state is shared by every wave and the warm-up, so the slots
    this prompt does not fill must not keep an earlier wave's keys)."""
    if "k_slabs" in cache:
        scatter = (scatter_prefill_pooled if layout.pools > 1
                   else scatter_prefill_plain)
        scatter(cache["k_slabs"][li], cache["v_slabs"][li], k, v, phys_blocks,
                positions, cfg.kv_block_tokens)
        return
    _store_ring((cache["ring_k"][li], cache["ring_v"][li]), k, v, g.window)


def _store_ring(rings: Tuple[torch.Tensor, torch.Tensor], k: torch.Tensor,
                v: torch.Tensor, W: int) -> None:
    """The last ``min(S, W)`` tokens of k, v [B,S,K,hd] into rings [B,W,K,hd]
    (views allowed) rebuilt from zeros."""
    S = k.shape[1]
    src = torch.arange(max(S - W, 0), S, device=k.device)
    for ring, t in zip(rings, (k, v)):
        ring.zero_()
        ring[:, src % W] = t[:, src].to(ring.dtype)


def _store_kv_shard(cfg: ModelConfig, g: LayerGroup,
                    cache: Dict[str, torch.Tensor], li: int,
                    positions: torch.Tensor, phys_blocks: torch.Tensor,
                    layout: CacheLayout):
    """The prefill's cache write of one model shard (``attend_tp``'s
    ``store``): its kv heads of the replicated slabs or ring, or its own
    split slabs or ring; pooled slabs through each row's pool."""
    def store(i, heads, k, v):
        if "ring_k" in cache:
            _store_ring((_kv_of(cache["ring_k"][li], i, heads, layout.split),
                         _kv_of(cache["ring_v"][li], i, heads, layout.split)),
                        k, v, g.window)
            return
        ks, vs = cache["k_slabs"][li], cache["v_slabs"][li]
        if layout.split:                      # [p, (P,) N, bt, Ks, hd]
            ks, vs = ks[i], vs[i]
        else:
            rng = slice(heads.kv0, heads.kv0 + heads.Ks)
            ks, vs = ks[..., rng, :], vs[..., rng, :]
        scatter = (scatter_prefill_pooled if layout.pools > 1
                   else scatter_prefill_plain)
        scatter(ks, vs, k, v, phys_blocks, positions, cfg.kv_block_tokens)
    return store


def _layer(cfg: ModelConfig, g: LayerGroup, li: int, lp: PyTree,
           x: torch.Tensor, positions: torch.Tensor, rope, *,
           cache: Optional[Dict[str, torch.Tensor]] = None,
           phys_blocks: Optional[torch.Tensor] = None,
           enc_out: Optional[torch.Tensor] = None,
           tp: Optional[Pods] = None, seq: Optional[SeqParallel] = None,
           layout: CacheLayout = CacheLayout()
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Layer ``li`` of group ``g`` over a whole sequence x [B,S,D] (with
    ``seq``: the shards' rows [p, B, S/t, D]): (x, its MoE aux loss or
    None).  With ``cache`` it also fills its part of the group's decode
    state (``_run_group``), held as ``layout`` says.  Each residual block
    goes through ``_block``."""
    causal = g.kind != "enc_attn"
    if g.kind in ("ssd", "rglru"):
        fwd = ssd_forward if g.kind == "ssd" else rglru_forward
        split = tp is not None and lp[g.kind][
            "in_proj" if g.kind == "ssd" else "rg_in"].dim() == 3

        def mixer(h, ax):
            if cache is None:
                return fwd(cfg, lp[g.kind], h, tp=ax), None
            out, state = fwd(cfg, lp[g.kind], h, return_state=True, tp=ax)
            _store_state(cache, li, state)
            return out, None
    elif cfg.mla:
        if tp is not None:
            raise ValueError(f"{cfg.name}: latent attention runs unsplit")
        split = False

        def store(latent):
            scatter_latent(cache["latent"][li], latent, phys_blocks,
                           positions, cfg.kv_block_tokens, layout.pools)

        def mixer(h, ax):
            return mla_attend(cfg, lp["attn"], h, rope, causal=causal,
                              store=None if cache is None else store), None
    elif tp is not None and heads_sharded(lp["attn"]):
        split = True
        store = (None if cache is None else
                 _store_kv_shard(cfg, g, cache, li, positions, phys_blocks,
                                 layout))

        def mixer(h, ax):
            return attend_tp(cfg, lp["attn"], h, rope, ax, causal=causal,
                             window=g.window, store=store), None
    else:
        split = False

        def store(k, v):
            _store_kv(cfg, g, cache, li, k, v, positions, phys_blocks, layout)

        def mixer(h, ax):
            q, k, v = project_qk_rope_v(cfg, lp["attn"], h, rope)
            return attend(cfg, lp["attn"], q, k, v, causal=causal,
                          window=g.window,
                          store=None if cache is None else store), None
    with tracing.span(_mixer_span(g)):
        x, _ = _block(cfg, x, lp["norm1"], mixer, tp, seq, split)
    if g.kind == "ssd":                 # an SSD layer has no FFN
        return x, None
    if g.kind == "dec_attn":
        if cache is not None:
            ck, cv, split = cache["cross_k"][li], cache["cross_v"][li], layout.split
        else:                           # each shard's own, stacked
            (ck, cv), split = _cross_kv(cfg, lp["cross"], enc_out, tp), True
        x, _ = _block(cfg, x, lp["norm_cross"],
                      lambda h, ax: (_cross_attend(cfg, lp["cross"], h, ck,
                                                   cv, ax, split), None),
                      tp, seq, tp is not None and heads_sharded(lp["cross"]))
    with tracing.span("ffn"):
        return _ffn_block(cfg, lp, x, tp, seq)


def _mixer_span(g: LayerGroup) -> str:
    """The span of a layer's token mixer: ``attn`` for attention, else the
    group's kind."""
    return "attn" if g.kind in ATTN_KINDS else g.kind


#: the values ``remat`` takes, as in the reference's ``_run_groups``
REMAT = (False, True, "full", "dots")

#: the products ``"dots"`` keeps: JAX's ``dots_with_no_batch_dims_saveable``
#: saves a dot_general's output when it has no batch dimension, the
#: projections and the head; on the port's dispatcher those are ``aten.mm``
#: (a [B,S,D] @ [D,F] product is flattened into one) and ``aten.addmm``.
#: Every other op is recomputed in the backward: norms, rope, activations,
#: the attention (K2 and its LSE, or on the CPU its plain ``bmm``s) and the
#: MoE's expert ``bmm``s, whose expert index is a batch dimension.
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_policy(remat) -> Optional[str]:
    """``remat`` -> None (keep every activation), ``"full"`` or ``"dots"``;
    ``True`` means ``"full"``, as in the reference."""
    if remat not in REMAT:
        raise ValueError(f"remat {remat!r}: one of {REMAT}")
    if remat is False:
        return None
    return "full" if remat is True else remat


def _recording(x: torch.Tensor, lp: PyTree) -> bool:
    """Whether autograd records a layer on ``x`` with parameters ``lp``."""
    return torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in tree_leaves(lp)))


def _rematerialised(layer, policy: str, *args, **kwargs):
    """``layer(*args, **kwargs)`` under ``torch.utils.checkpoint``: its
    activations are dropped after the forward and recomputed in the
    backward (``"full"``), or all but the outputs of ``_SAVED_DOTS``
    (``"dots"``).  The outputs are the first forward's (the MoE aux loss is
    counted once); the recomputation runs the layer again, its kernels and
    its model-axis collectives included, in the backward's order, which is
    the same on every rank.  No layer draws random numbers, so the RNG
    state is not stashed."""
    context = (functools.partial(create_selective_checkpoint_contexts,
                                 _dots_policy)
               if policy == "dots" else noop_context_fn)
    return checkpoint(layer, *args, use_reentrant=False,
                      preserve_rng_state=False, context_fn=context, **kwargs)


def _run_group(cfg: ModelConfig, g: LayerGroup, gp: PyTree, x: torch.Tensor,
               positions: torch.Tensor, *,
               cache: Optional[Dict[str, torch.Tensor]] = None,
               phys_blocks: Optional[torch.Tensor] = None,
               enc_out: Optional[torch.Tensor] = None,
               tp: Optional[Pods] = None, remat=False,
               seq: Optional[SeqParallel] = None,
               layout: CacheLayout = CacheLayout(), first: int = 0
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One layer group over a whole sequence x [B,S,D] (with ``seq``: the
    shards' rows): (x, the summed MoE aux loss or None).  With ``cache`` (the
    group's decode state, held as ``layout`` says) every
    layer also fills its part of it, in place: self-attention K/V
    (``_store_kv``), the SSD / RG-LRU state, and a decoder layer reads its
    cross K/V from it; without, a decoder layer projects ``enc_out``.
    ``remat`` (``remat_policy``) rematerialises each layer of a training
    forward (no cache, autograd recording); a prefill is never wrapped.
    Each layer is a ``layer`` span counting its ``index``, ``first`` + its
    place in the group."""
    rope = (rope_for(cfg, positions, g.rope_theta) if g.kind in ATTN_KINDS
            else None)
    policy = remat_policy(remat)
    aux: Optional[torch.Tensor] = None
    for li, lp in enumerate(gp):
        args = (cfg, g, li, lp, x, positions, rope)
        kw = dict(cache=cache, phys_blocks=phys_blocks, enc_out=enc_out, tp=tp,
                  seq=seq, layout=layout)
        with tracing.span("layer", index=first + li):
            if policy is not None and cache is None and _recording(x, lp):
                x, a = _rematerialised(_layer, policy, *args, **kw)
            else:
                x, a = _layer(*args, **kw)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def _cross_kv(cfg: ModelConfig, p: PyTree, enc_out: torch.Tensor,
              tp: Optional[Pods]) -> Tuple[torch.Tensor, torch.Tensor]:
    """A decoder layer's cross K/V of ``enc_out``: [B, Se, K, hd], or each
    local shard's [p, B, Se, Ks, hd] when its heads split over ``tp``."""
    if tp is not None and heads_sharded(p):
        return cross_kv_tp(cfg, p, enc_out, tp)
    return cross_kv(cfg, p, enc_out)


def _cross_attend(cfg: ModelConfig, p: PyTree, x: torch.Tensor,
                  ck: torch.Tensor, cv: torch.Tensor,
                  tp: Optional[Pods], split: bool) -> torch.Tensor:
    """Cross-attention on ck / cv: each shard's own stacked ``[p, ...]``
    (``split``) or held once, when the heads split over ``tp``."""
    if tp is not None and heads_sharded(p):
        return cross_attention_tp(cfg, p, x, ck, cv, tp, split=split)
    return cross_attention(cfg, p, x, ck, cv)


def forward_lm(cfg: ModelConfig, params: PyTree, tokens: torch.Tensor,
               tp: Optional[Pods] = None, *, remat=True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decoder-only LM forward.  tokens: [B,S] int -> (logits [B,S,V], aux);
    aux is the sum of the MoE layers' auxiliary losses, zero for a dense
    config.  Over a vocab-split model axis ``tp`` the logits are the local
    shards' [p,B,S,V/t] (``gather_vocab`` joins them).  ``remat``: each
    layer rematerialised when autograd records (``_run_group``).  Under
    rules that put ``act_seq`` on ``model``, Megatron sequence parallelism
    over ``tp`` (module doc)."""
    groups = require_ported(cfg)
    tp = model_axis(tp)
    seq = seq_shards(tp, tokens.shape[1])
    x = _embed(cfg, params, tokens, tp, seq)
    positions = _positions(*tokens.shape, tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for g, gp in zip(groups, params["groups"]):
        x, a = _run_group(cfg, g, gp, x, positions, tp=tp, remat=remat,
                          seq=seq)
        if a is not None:
            aux = aux + a
    return _lm_head(cfg, params, x, tp, seq), aux


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


def _encode(cfg: ModelConfig, params: PyTree, enc_feats: torch.Tensor,
            tp: Optional[Pods] = None, remat=False) -> torch.Tensor:
    """The encoder over frame embeddings enc_feats [B,Se,D] (the audio
    frontend is a stub, as in the reference) -> enc_out [B,Se,D] float32.

    The reference adds float32 sinusoids to the frames in ``cfg.dtype``, and
    its type promotion then carries the whole encoder in float32, each
    product on weights rounded to ``cfg.dtype``.  The port computes the
    same: the encoder's layers under a float32 config, on its matrices
    rounded once.  ``tp``: the model axis; ``remat``: as ``_run_group``'s.
    Under sequence parallelism the frames split over ``tp`` between blocks
    where t divides them, gathered whole after the final norm."""
    B, Se, _ = enc_feats.shape
    g = require_ported(cfg)[0]
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    x = (enc_feats.to(cfg.dtype).float()
         + _sinusoids(Se, cfg.d_model, enc_feats.device)[None])
    seq = seq_shards(model_axis(tp), Se)
    if seq is not None:
        x = seq.tp.scatter_dim(x, 1)
    x, _ = _run_group(cfg32, g, _round_weights(params["groups"][0], cfg.dtype),
                      x, _positions(B, Se, x.device), tp=tp, remat=remat,
                      seq=seq)
    if seq is None:
        return apply_norm(cfg32, x, params["enc_norm"])
    return seq.gather(seq.norm(cfg32, x, params["enc_norm"]), partial=False)


def forward_encdec(cfg: ModelConfig, params: PyTree, enc_feats: torch.Tensor,
                   dec_tokens: torch.Tensor, tp: Optional[Pods] = None, *,
                   remat=True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whisper-style: enc_feats [B,Se,D] (frontend stub), dec_tokens [B,Sd]
    -> (logits [B,Sd,V], aux (zero: no MoE)).  ``tp``: the model axis;
    ``remat``: the encoder's and the decoder's layers rematerialised when
    autograd records, as the reference wraps both groups.  Under sequence
    parallelism each stack splits where t divides its length."""
    dec_g = require_ported(cfg)[1]
    tp = model_axis(tp)
    enc_out = _encode(cfg, params, enc_feats, tp, remat)
    positions = _positions(*dec_tokens.shape, dec_tokens.device)
    seq = seq_shards(tp, dec_tokens.shape[1])
    y = _dec_embed(cfg, params, dec_tokens, positions)
    if seq is not None:
        y = seq.tp.scatter_dim(y, 1)
    y, _ = _run_group(cfg, dec_g, params["groups"][1], y, positions,
                      enc_out=enc_out, tp=tp, remat=remat, seq=seq)
    return (_lm_head(cfg, params, y, seq=seq),
            torch.zeros((), dtype=torch.float32, device=y.device))


def prefill_encdec(cfg: ModelConfig, params: PyTree, enc_feats: torch.Tensor,
                   dec_tokens: torch.Tensor, state: "DecodeState",
                   phys_blocks: torch.Tensor, tp: Optional[Pods] = None
                   ) -> Tuple[torch.Tensor, "DecodeState"]:
    """Whisper-style prefill: run the encoder, fill each decoder layer's
    cross K/V from its output, then prefill the decoder prompt [B,Sd] (its
    self-attention K/V scattered into the paged slabs through the block
    table).  The caches of ``state`` (made with ``enc_len`` = Se) are
    written in place.  ``tp``: the model axis (each shard's cross K/V into
    its split cache, or into its kv heads of the replicated one); sequence parallelism
    as ``forward_encdec``'s.  Returns (logits of the last position [B,V],
    state)."""
    dec_g = require_ported(cfg)[1]
    tp = model_axis(tp)
    dec_cache, dp = state.caches[1], params["groups"][1]
    layout = state.layout
    enc_out = _encode(cfg, params, enc_feats, tp)
    for li, lp in enumerate(dp):
        ck, cv = _cross_kv(cfg, lp["cross"], enc_out, tp)
        whole = tp is None or not heads_sharded(lp["cross"])
        for name, kv in (("cross_k", ck), ("cross_v", cv)):
            cache = dec_cache[name][li]
            if whole or layout.split:             # whole, or split alike
                cache.copy_(kv)
                continue
            for i, shard in enumerate(tp.local_indices()):
                _kv_of(cache, i, ShardHeads(cfg, lp["cross"], shard),
                       False).copy_(kv[i])
    B, Sd = dec_tokens.shape
    positions = _positions(B, Sd, dec_tokens.device)
    seq = seq_shards(tp, Sd)
    y = _dec_embed(cfg, params, dec_tokens, positions)
    if seq is not None:
        y = seq.tp.scatter_dim(y, 1)
    y, _ = _run_group(cfg, dec_g, dp, y, positions, cache=dec_cache,
                      phys_blocks=phys_blocks, tp=tp, seq=seq, layout=layout)
    logits = _lm_head(cfg, params, y[:, -1] if seq is None
                      else seq.last_rows(y))
    seq_lens = torch.full((B,), Sd, dtype=torch.int32, device=y.device)
    return logits, state._replace(seq_lens=seq_lens)


def _vocab_parallel_ll(logits: torch.Tensor, targets: torch.Tensor,
                       tp: Pods) -> torch.Tensor:
    """log p(target) from vocab shards [p, B, S, V/t], float32: the max by
    ``pmax``, the sum of exponentials and the target's logit by ``psum``."""
    local = logits.float()
    Vs = local.shape[-1]
    m = tp.pmax(local.detach().amax(-1))                       # [p, B, S]
    lse = m + torch.log(tp.psum(torch.exp(local - m[..., None]).sum(-1)))
    picks = []
    for i, shard in enumerate(tp.local_indices()):
        ids = targets - shard * Vs
        inside = (ids >= 0) & (ids < Vs)
        got = local[i].gather(-1, ids.clamp(0, Vs - 1)[..., None])[..., 0]
        picks.append(torch.where(inside, got, torch.zeros_like(got)))
    return (tp.psum(torch.stack(picks)) - lse)[0]


def lm_loss(cfg: ModelConfig, params: PyTree, batch: Dict[str, torch.Tensor],
            tp: Optional[Pods] = None, *, remat=True
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy on a float32 log-softmax, plus 0.01 times
    the MoE aux loss.  batch: ``tokens`` [B,S+1] (and ``enc_feats`` [B,Se,D]
    for an encoder-decoder), optionally ``mask`` [B,S+1] (position 0 is
    dropped with the inputs).  ``tp``: the model axis (the log-softmax over
    vocab shards, never gathered); ``remat``: each layer rematerialised
    (``_run_group``; the reference's default); sequence parallelism as
    ``forward_lm``'s.  Returns (total, {loss, aux, tokens})."""
    tokens = batch["tokens"]
    tp = model_axis(tp)
    if cfg.family == "encdec":
        logits, aux = forward_encdec(cfg, params, batch["enc_feats"],
                                     tokens[:, :-1], tp, remat=remat)
    else:
        logits, aux = forward_lm(cfg, params, tokens[:, :-1], tp,
                                 remat=remat)
    targets = tokens[:, 1:].long()
    if tp is not None and vocab_split(params):
        ll = _vocab_parallel_ll(logits, targets, tp)
    else:
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
    """Per-group caches (tuple indexed like layer_groups(cfg)), the rows'
    lengths, and how the caches are held (``layout``, recorded by
    ``init_decode_state``; a new state is ``state._replace(...)``)."""
    caches: Tuple[Dict[str, torch.Tensor], ...]
    seq_lens: torch.Tensor        # [B] tokens so far (incl. prompt), int32
    layout: CacheLayout


def init_decode_state(cfg: ModelConfig, batch: int, n_blocks: int,
                      max_blocks: int, *, enc_len: int = 0, n_pools: int = 1,
                      kv_split: int = 1, state_split: int = 1, dtype=None,
                      device: DeviceLike = None) -> DecodeState:
    """n_blocks: physical KV frames in the pool; max_blocks: per-seq table;
    enc_len: encoder frames (the cross K/V of an encoder-decoder).  Global
    attention groups get paged slabs ``[L, n_blocks, bt, K, hd]``, or with
    ``n_pools`` > 1 pool-partitioned ones ``[L, n_pools, n_blocks //
    n_pools, bt, K, hd]`` (numaPTE's partitioned KV: each row's frames in
    its own pool); latent attention (``cfg.mla``) one such ``latent`` slab
    of ``[..., bt, 1, kv_lora_rank + qk_rope_head_dim]`` in their place;
    windowed groups a ring of ``window`` slots per sequence,
    SSD and RG-LRU groups a float32 state ``h`` and a conv tail, the encoder
    nothing.  ``kv_split`` = t > 1 splits the slabs', the rings' and the
    cross K/V's kv heads over t model shards, ``[L, t, ..., K / t, hd]``
    (pooled slabs ``[L, t, n_pools, n_blocks // n_pools, bt, K / t, hd]``:
    one contiguous paged-kernel operand a shard, its pools flattened); the
    default holds them once, replicated over the model axis.
    ``state_split`` = t > 1 holds each model shard's recurrent state, ``[L,
    t, ...]`` of its heads or channels (``launch/specs.py:state_split``).
    The state records all three (``CacheLayout``).  All zeros: a masked
    slot must hold a finite value."""
    if cfg.mla and kv_split > 1:
        raise ValueError(f"{cfg.name}: latent attention's slab does not "
                         "split over the model axis")
    if cfg.n_kv_heads % kv_split:
        raise ValueError(f"{cfg.n_kv_heads} kv heads do not split over "
                         f"{kv_split} shards")
    if n_blocks % n_pools:
        raise ValueError(f"{n_blocks} frames do not split over {n_pools} pools")
    slab_dims = (((kv_split,) if kv_split > 1 else ())
                 + ((n_pools, n_blocks // n_pools) if n_pools > 1
                    else (n_blocks,)))
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    hd, K = cfg.resolved_head_dim, cfg.n_kv_heads
    bt, W1 = cfg.kv_block_tokens, cfg.conv_width - 1
    kv = ((kv_split,) if kv_split > 1 else (), K // kv_split)
    ts = state_split
    rec = (ts,) if ts > 1 else ()
    caches: List[Dict[str, torch.Tensor]] = []
    for g in require_ported(cfg):
        L = g.n_layers
        shapes: Dict[str, Tuple[Tuple[int, ...], Any]] = {}
        if g.kind == "ssd":
            shapes = {"h": ((L,) + rec + (batch, cfg.ssm_n_heads // ts,
                                           cfg.ssm_state, cfg.ssm_head_dim),
                            torch.float32),
                      "conv": ((L,) + rec + (batch, W1, (cfg.d_inner + 2 *
                                                         cfg.ssm_state) // ts),
                               dtype)}
        elif g.kind == "rglru":
            w = (cfg.lru_width or cfg.d_model) // ts
            shapes = {"h": ((L,) + rec + (batch, w), torch.float32),
                      "conv": ((L,) + rec + (batch, W1, w), dtype)}
        elif cfg.mla:
            shapes = {"latent": ((L,) + slab_dims + (
                bt, 1, cfg.kv_lora_rank + cfg.qk_rope_head_dim), dtype)}
        elif g.kind in ("attn", "dec_attn") and g.window is None:
            shapes = {n: ((L,) + slab_dims + (bt, kv[1], hd), dtype)
                      for n in ("k_slabs", "v_slabs")}
            if g.kind == "dec_attn":
                shapes.update({n: ((L,) + kv[0] + (batch, enc_len, kv[1], hd),
                                   dtype) for n in ("cross_k", "cross_v")})
        elif g.kind == "attn":
            shapes = {n: ((L,) + kv[0] + (batch, g.window, kv[1], hd), dtype)
                      for n in ("ring_k", "ring_v")}
        caches.append({n: torch.zeros(shape, dtype=dt, device=device)
                       for n, (shape, dt) in shapes.items()})
    return DecodeState(tuple(caches),
                       torch.zeros((batch,), dtype=torch.int32, device=device),
                       CacheLayout(n_pools, kv_split, state_split))


def decode_step(cfg: ModelConfig, params: PyTree, state: DecodeState,
                tokens: torch.Tensor, phys_blocks: torch.Tensor, *,
                sp: bool = False, pods: Optional[Pods] = None,
                tp: Optional[Pods] = None
                ) -> Tuple[torch.Tensor, DecodeState]:
    """One token per sequence.  tokens: [B]; phys_blocks: [B, max_blocks]
    int32 physical frame ids from the block-table translation (local to a
    row's pool when the slabs are pooled).  The caches of ``state`` are
    written in place.  ``sp``: sequence-parallel decode of the global layers
    over the pools (the table's columns split over them; over ``pods`` when
    given).  ``tp``: the model axis (vocab-split logits then come as the
    local shards' [p, B, V/t]); with ``sp`` each model shard decodes its
    heads sequence-parallel and the shards' row-parallel outputs are summed
    over it.  Returns (logits [B,V], new state).  Its ``decode`` span counts
    ``graph`` = 0: a replay of the step's CUDA graph is a span of its own
    (``launch/step_graph.py``)."""
    with tracing.span("decode", graph=0):
        tp = model_axis(tp)
        positions = state.seq_lens                   # position of new token
        with tracing.span("embed"):
            if cfg.family == "encdec":
                x = _dec_embed(cfg, params, tokens[:, None],
                               positions[:, None])
            else:
                x = _embed(cfg, params, tokens, tp)[:, None]
        seq_lens = state.seq_lens + 1
        first = 0
        for g, gp, cache in zip(require_ported(cfg), params["groups"],
                                state.caches):
            if g.kind == "enc_attn":                # no decode state
                continue
            x = _decode_group(cfg, g, gp, cache, x, positions, phys_blocks,
                              seq_lens, state.layout, sp=sp, pods=pods, tp=tp,
                              first=first)
            first += len(gp)
        with tracing.span("head"):
            logits = _lm_head(cfg, params, x, tp)[..., 0, :]
        return logits, state._replace(seq_lens=seq_lens)


def _decode_group(cfg: ModelConfig, g: LayerGroup, gp: PyTree,
                  cache: Dict[str, torch.Tensor], x: torch.Tensor,
                  positions: torch.Tensor, phys_blocks: torch.Tensor,
                  seq_lens: torch.Tensor, layout: CacheLayout, *,
                  sp: bool = False, pods: Optional[Pods] = None,
                  tp: Optional[Pods] = None, first: int = 0) -> torch.Tensor:
    """One decode step of a layer group.  Each layer is a ``layer`` span
    counting its ``index`` (``first`` + its place in the group) that holds
    its mixer's span (``_mixer_span``) and its FFN's (``ffn``)."""
    rope = (rope_for(cfg, positions[:, None], g.rope_theta)
            if g.kind in ATTN_KINDS else None)
    mixer = _mixer_span(g)
    for li, lp in enumerate(gp):
        with tracing.span("layer", index=first + li):
            with tracing.span(mixer):
                h = _norm(cfg, x, lp["norm1"])
                if g.kind in ("ssd", "rglru"):
                    step = ssd_decode if g.kind == "ssd" else rglru_decode
                    a, hs, conv = step(cfg, lp[g.kind], h, cache["h"][li],
                                       cache["conv"][li], tp=tp)
                    _store_state(cache, li, {"h": hs, "conv": conv})
                elif tp is not None and heads_sharded(lp["attn"]) and g.window:
                    a = attn_decode_ring_tp(
                        cfg, lp["attn"], h, positions,
                        (cache["ring_k"][li], cache["ring_v"][li]), rope=rope,
                        tp=tp, window=g.window, split=layout.split)
                elif tp is not None and heads_sharded(lp["attn"]):
                    a = attn_decode_paged_tp(
                        cfg, lp["attn"], h, positions,
                        (cache["k_slabs"][li], cache["v_slabs"][li]),
                        phys_blocks, seq_lens, rope=rope, tp=tp,
                        layout=layout, sp=sp, pods=pods)
                elif cfg.mla:
                    if sp or tp is not None:
                        raise ValueError(f"{cfg.name}: latent attention "
                                         "decodes unsplit, without SP")
                    a = attn_decode_mla(
                        cfg, lp["attn"], h, positions, cache["latent"][li],
                        phys_blocks, seq_lens, rope=rope, pools=layout.pools)
                elif g.window is None:
                    a, _ = attn_decode_paged(
                        cfg, lp["attn"], h, positions,
                        (cache["k_slabs"][li], cache["v_slabs"][li]),
                        phys_blocks, seq_lens, rope=rope, sp=sp, pods=pods,
                        pools=layout.pools)
                else:
                    a, _, _ = attn_decode_ring(
                        cfg, lp["attn"], h, positions, cache["ring_k"][li],
                        cache["ring_v"][li], rope=rope, window=g.window)
                x = x + a
            if g.kind == "ssd":                 # an SSD layer has no FFN
                continue
            if g.kind == "dec_attn":
                h = apply_norm(cfg, x, lp["norm_cross"])
                x = x + _cross_attend(cfg, lp["cross"], h,
                                      cache["cross_k"][li],
                                      cache["cross_v"][li], tp, layout.split)
            with tracing.span("ffn"):
                x, _ = _ffn_block(cfg, lp, x, tp)
    return x


def prefill(cfg: ModelConfig, params: PyTree, tokens: torch.Tensor,
            state: DecodeState, phys_blocks: torch.Tensor,
            tp: Optional[Pods] = None) -> Tuple[torch.Tensor, DecodeState]:
    """Prefill a prompt batch [B,S]: full forward + every layer's state into
    the caches of ``state`` (in place): K/V scattered into the slabs through
    the block table, or the last ``min(S, W)`` tokens into a ring rebuilt
    from zeros, or the SSD / RG-LRU state after the prompt.  ``tp``: the
    model axis, as for ``decode_step``; sequence parallelism as
    ``forward_lm``'s (the caches and the logits are the same).
    Returns (logits of the last position [B,V], new state)."""
    with tracing.span("prefill"):
        B, S = tokens.shape
        tp = model_axis(tp)
        seq = seq_shards(tp, S)
        with tracing.span("embed"):
            x = _embed(cfg, params, tokens, tp, seq)
        positions = _positions(B, S, tokens.device)
        first = 0
        for g, gp, cache in zip(require_ported(cfg), params["groups"],
                                state.caches):
            x, _ = _run_group(cfg, g, gp, x, positions, cache=cache,
                              phys_blocks=phys_blocks, tp=tp, seq=seq,
                              layout=state.layout, first=first)
            first += len(gp)
        with tracing.span("head"):
            logits = _lm_head(cfg, params, x[:, -1] if seq is None
                              else seq.last_rows(x), tp)
        seq_lens = torch.full((B,), S, dtype=torch.int32,
                              device=tokens.device)
        return logits, state._replace(seq_lens=seq_lens)


def greedy_sample(logits: torch.Tensor, tp: Optional[Pods] = None
                  ) -> torch.Tensor:
    """argmax over the vocab, int32.  ``tp``: the logits are vocab shards
    [p, ..., V/t] of the model axis: each shard's max and its first index,
    gathered, then the lowest global index among the equal maxima
    (``argmax``'s tie rule)."""
    if tp is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    Vs = logits.shape[-1]
    best = logits.amax(-1)                                    # [p, ...]
    offset = torch.tensor(tp.local_indices(), device=logits.device) * Vs
    first = torch.argmax(logits, dim=-1) + offset.view(
        (-1,) + (1,) * (logits.dim() - 2))
    best_all, first_all = tp.all_gather(best)[0], tp.all_gather(first)[0]
    top = best_all.amax(0)
    none = torch.full_like(first_all, torch.iinfo(first_all.dtype).max)
    return torch.where(best_all == top, first_all, none).amin(0).to(torch.int32)
