"""Roofline terms of a dry-run cell on the H100, from analytic counts.

The reference reads its three terms off the compiled XLA artifact (HLO FLOPs
and bytes, collective shapes; ``hlo_analysis.py`` and ``collective_stats``).
The port has no compiled artifact: it counts what it executes for a cell
(``launch/specs.py:build_cell``) from the cell's own tensors and the
config, per device of the grid, and scales to the whole machine:

    compute    = flops            / (chips * PEAK_FLOPS)
    memory     = bytes            / (chips * HBM_BW)
    collective = wire bytes       / (chips * LINK_BW)

  * ``step_flops`` / ``cell_flops``: every product at 2 m n k (a weight
    [m, n] read by k tokens, the device's slice of a split leaf; the MoE's
    experts over their capacity slots); attention by its span (the causal
    or windowed pairs K2 visits, the context K1 reads); the SSD's chunk
    products.  A train step is the forward, a backward of twice the
    products and 2.5 times the attention (K2's backward recomputes the
    scores and makes four products), and with ``remat`` one more forward of
    every layer (``"dots"`` keeps the products' outputs, so only the
    attention, the experts' batched products and the SSD core run again).
  * ``cell_bytes``: the HBM traffic of a step: weights read once a pass in
    their stored dtype, gradients written and the AdamW state read and
    written (28 bytes a float32 parameter), each layer's residual stream
    read and written once a pass, the logits and their float32
    log-softmax, the KV written by a prefill, and the KV, rings, cross K/V
    and recurrent states that a decode reads.
  * ``cell_wire_bytes``: the model axis's collectives as ``Pods`` counts
    them (each collective's per-shard slice received by t - 1 shards, on
    each of t; ``model_wire``); the data axis's gradient all-reduce at the
    ring factor 2 (d - 1) / d; the pod axis's gradient leg (float32 ring
    or the int8 all-gather; over a split model axis each split leaf's scale
    adds one model-axis ``pmax`` of a float32 a line), the coherence
    prologue's buffers, and a sequence-parallel decode's combine of each
    device's heads over the pods (``sp_combine_wire``).  Under
    Megatron sequence parallelism (``cell.seq_split``) a block's psum
    becomes a reduce-scatter and its input's ``copy_in`` an all-gather,
    each moving 1/t of the block's rows a shard pair: the model axis then
    moves 2/t of a psum's bytes a block by ``Pods``' count, where a ring's
    reduce-scatter + all-gather move what its all-reduce does.
  * ``per_device_bytes``: summed from the cell's own tensors, each over the
    devices it is split over; ``device_bytes`` counts the same from the
    config's widths, and the two must agree.

Hardware constants are the NVIDIA H100 SXM5 80 GB's datasheet values: 989
TFLOP/s dense bf16, 3.35 TB/s of HBM3, and NVLink 4 at 900 GB/s a GPU, both
directions together: 450e9 B/s each way.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from .._tree import tree_leaves, tree_leaves_with_path, tree_map
from ..models import active_param_count, init_params, layer_groups
from ..models.common import SHAPES_ONLY, ModelConfig
from ..models.moe import expert_capacity
from .specs import (MISS_BUDGET, MUTATION_BUDGET, PREFETCH_DEGREE,
                    TABLE_ENTRIES, _decode_geometry, _row_share, _split_dim,
                    kv_split, param_shardings, split_leaves, state_split)

# --- hardware constants (NVIDIA H100 SXM5 80 GB datasheet) ------------------
PEAK_FLOPS = 989e12          # bf16 FLOP/s a GPU, dense tensor cores
PEAK_FLOPS_F32 = 67e12       # float32 FLOP/s a GPU, outside the tensor cores
HBM_BW = 3.35e12             # bytes/s a GPU
LINK_BW = 450e9              # bytes/s a GPU, each direction (NVLink 4: 900 GB/s both)
HBM_BYTES = 80 * 2 ** 30     # device memory a GPU (80 GiB)

ATTN_KINDS = ("attn", "enc_attn", "dec_attn")


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float
    bytes: float
    collective_bytes: float
    model_flops: float
    compute_s: float
    memory_s: float
    collective_s: float
    per_device_bytes: float
    collectives: Dict[str, float]

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute fraction at the bound: how close the step would
        run to the compute roofline if it achieved the bound time."""
        ideal = self.model_flops / (self.chips * PEAK_FLOPS)
        return ideal / self.bound_s if self.bound_s > 0 else 0.0

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def fits(self) -> bool:
        """Whether one device holds the cell's arguments (its parameters,
        optimizer state, batch and decode state; activations come on top)."""
        return self.per_device_bytes <= HBM_BYTES

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d.update(dominant=self.dominant, bound_s=self.bound_s,
                 roofline_fraction=self.roofline_fraction,
                 useful_flops_ratio=self.useful_flops_ratio, fits=self.fits)
        return d


# --------------------------------------------------------------------------- model flops
def model_flops_train(cfg, shape) -> float:
    """6*N_active*D for a training step (fwd+bwd)."""
    tokens = shape.global_batch * shape.seq_len
    return 6.0 * active_param_count(cfg) * tokens


def model_flops_decode(cfg, shape) -> float:
    """2*N_active per token + attention KV reads (2*T*d per kv-layer pair)."""
    flops = 2.0 * active_param_count(cfg) * shape.global_batch
    # attention over the cache: 2 * 2 * T * n_kv_heads*hd per global layer
    hd = cfg.resolved_head_dim
    n_global = _n_paged_layers(cfg)
    flops += (4.0 * shape.seq_len * cfg.n_heads * hd
              * n_global * shape.global_batch)
    return flops


def model_flops_prefill(cfg, shape) -> float:
    tokens = shape.global_batch * shape.seq_len
    flops = 2.0 * active_param_count(cfg) * tokens
    hd = cfg.resolved_head_dim
    for g in layer_groups(cfg):
        if g.kind not in ATTN_KINDS:
            continue
        span = min(g.window or shape.seq_len, shape.seq_len)
        flops += (2.0 * 2.0 * shape.global_batch * shape.seq_len * span
                  * cfg.n_heads * hd * g.n_layers) / 2.0
    return flops


def _n_paged_layers(cfg) -> int:
    return sum(g.n_layers for g in layer_groups(cfg)
               if g.kind in ("attn", "dec_attn") and g.window is None)


def model_flops(cfg, shape) -> float:
    return {"train": model_flops_train,
            "prefill": model_flops_prefill,
            "decode": model_flops_decode}[shape.step](cfg, shape)


# --------------------------------------------------------------------------- the cell
def _split(path, leaf) -> bool:
    return _split_dim(path, leaf) is not None


def _dev_numel(path, leaf, t: int) -> int:
    """Elements of ``leaf`` one device holds: a split leaf [t, ...] one
    shard's slice."""
    return leaf.numel() // t if _split(path, leaf) else leaf.numel()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def per_device_bytes(cell) -> float:
    """Bytes of the cell's arguments on one device: each leaf's bytes over
    the number of devices it is split over (``cell.shares``)."""
    return sum(_nbytes(leaf) / share
               for leaf, share in zip(tree_leaves(cell.args), cell.shares))


def visible_pairs(S: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs a sequence of S tokens attends: S^2 without a
    mask, S (S + 1) / 2 causal, and causal within a window W the pairs
    i - j < W."""
    if not causal:
        return S * S
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


class _Geometry:
    """What a cell's counts read: the config, the step, the device's rows,
    tokens a row (``tokens``; an encoder-decoder's decoder, and its
    ``enc_tokens`` frames), and the sharded parameters."""

    def __init__(self, cell):
        self.cfg: ModelConfig = cell.cfg
        self.step = cell.shape.step
        self.t = cell.grid.model.n
        self.data = cell.grid.n * cell.grid.data.n
        self.rows = cell.rows // _row_share(cell.rows, self.data)
        self.params = cell.args[0]
        self.S = cell.shape.seq_len
        self.remat = cell.opts.remat if self.step == "train" else False
        cfg = self.cfg
        # the decoder's context: an encoder-decoder decodes at most
        # max_decoder_len positions
        self.ctx = self.S
        if cfg.family == "encdec":
            self.ctx = min(self.S, cfg.max_decoder_len)
            self.enc_tokens = self.S
            self.tokens = {"train": cfg.max_decoder_len,
                           "prefill": cfg.max_decoder_len,
                           "decode": 1}[self.step]
        else:
            self.enc_tokens = 0
            self.tokens = 1 if self.step == "decode" else self.S
        self.el = torch.tensor([], dtype=cfg.dtype).element_size()
        # a decode step's table slots (the plain paged attention scores them
        # all; K1 reads the context)
        self.slots = (cell.args[3].shape[-1] * cfg.kv_block_tokens
                      if self.step == "decode" else 0)


def _layers(g: _Geometry):
    """(group, layer) of every layer the step runs (a decode step runs no
    encoder)."""
    for grp, gp in zip(layer_groups(g.cfg), g.params["groups"]):
        if g.step == "decode" and grp.kind == "enc_attn":
            continue
        for lp in gp:
            yield grp, lp


def _matrix_flops(g: _Geometry, path, leaf) -> float:
    """2 x the device's elements of a product's weight: its FLOPs a
    token."""
    return 2.0 * _dev_numel(path, leaf, g.t)


def _attn_heads(g: _Geometry, p) -> Tuple[int, int]:
    """(query heads, kv heads) one device computes in an attention layer:
    a shard's heads when ``wq`` is split (one kv head when ``wk`` stays
    replicated), all of them otherwise."""
    hd = g.cfg.resolved_head_dim
    H = p["wq"].shape[-1] // hd
    if p["wq"].dim() == 3:
        K = p["wk"].shape[-1] // hd if p["wk"].dim() == 3 else 1
        return H, K
    return H, p["wk"].shape[-1] // hd


def _product_flops(g: _Geometry, lp, kind: str) -> Dict[str, float]:
    """One layer's FLOPs a row: ``mm`` (products with no batch dimension),
    ``experts`` (the MoE's batched products over its capacity slots) and
    ``enc`` (products on the encoder frames: a decoder layer's cross K/V)."""
    cfg, hd = g.cfg, g.cfg.resolved_head_dim
    out = {"mm": 0.0, "experts": 0.0, "enc": 0.0}
    N = g.tokens if kind != "enc_attn" else g.enc_tokens
    for block in ("attn", "cross", "ffn", "rglru", "ssd"):
        if block not in lp:
            continue
        p = lp[block]
        for name, leaf in p.items():
            if leaf.dim() - int(_split((block, name), leaf)) < 2 or name == "conv_w":
                continue
            per_tok = _matrix_flops(g, (block, name), leaf)
            if block in ("attn", "cross") and name in ("wk", "wv") \
                    and p["wq"].dim() == 3 and leaf.dim() == 2:
                per_tok = 2.0 * cfg.d_model * _attn_heads(g, p)[1] * hd
            if block == "cross" and name in ("wk", "wv"):
                if g.step != "decode":        # decode reads the cached K/V
                    out["enc"] += per_tok * g.enc_tokens
                continue
            out["mm"] += per_tok * N
    if "moe" in lp:
        p = lp["moe"]
        out["mm"] += _matrix_flops(g, ("moe", "router"), p["router"]) * N
        C = expert_capacity(g.rows * N, cfg.n_experts, cfg.experts_per_token,
                            cfg.moe_capacity_factor)
        for name in ("we_in", "we_gate", "we_out"):
            if name in p:        # E_dev x C slots of a [D, F] product
                out["experts"] += 2.0 * C * _dev_numel(("moe", name), p[name],
                                                       g.t) / g.rows
        for name, leaf in p.get("shared", {}).items():
            out["mm"] += _matrix_flops(g, ("moe", "shared", name), leaf) * N
    return out


def _attention_flops(g: _Geometry, lp, grp, dense: bool
                     ) -> Tuple[float, float]:
    """A layer's attention FLOPs a row, forward: (self-attention, a
    decoder's cross-attention on the frames), 4 hd a (query, key) pair a
    query head (scores and P V).  A decode step reads the context (K1) or
    scores every slot of a ring (the plain ring decode); ``dense``: every
    pair of S^2, and every slot of the table at decode, as the plain
    versions compute them on the CPU."""
    cfg, hd = g.cfg, g.cfg.resolved_head_dim
    if grp.kind not in ATTN_KINDS:
        return 0.0, 0.0
    H, _ = _attn_heads(g, lp["attn"])
    if g.step == "decode":
        pairs = (grp.window if grp.window is not None
                 else g.slots if dense else g.ctx + 1)
    else:
        S = g.enc_tokens if grp.kind == "enc_attn" else g.tokens
        causal = grp.kind != "enc_attn"
        pairs = S * S if dense else visible_pairs(S, causal, grp.window)
    cross = 0.0
    if grp.kind == "dec_attn":
        Hc, _ = _attn_heads(g, lp["cross"])
        cross = 4.0 * Hc * hd * g.tokens * g.enc_tokens
    return 4.0 * H * hd * pairs, cross


def _ssd_flops(g: _Geometry, lp) -> float:
    """The SSD's chunk products a row, forward: within a chunk of Q, C B^T
    (2 Q^2 n) and its mask times x (2 Q^2 H P); the chunk states and their
    read-out (4 Q n H P); a decode step reads the state out (2 n H P; its
    update is elementwise)."""
    if "ssd" not in lp:
        return 0.0
    cfg = g.cfg
    H = _dev_numel(("ssd", "a_log"), lp["ssd"]["a_log"], g.t)
    n, P, Q = cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_chunk
    if g.step == "decode":
        return 2.0 * n * H * P
    chunks = -(-g.tokens // Q)
    return chunks * (2.0 * Q * Q * n + 2.0 * Q * Q * H * P + 4.0 * Q * n * H * P)


def _head_flops(g: _Geometry) -> float:
    """The head's FLOPs a row: on every position in training, on the last
    one in a prefill or a decode step."""
    p = g.params
    if "lm_head" in p:
        path, leaf = ("lm_head",), p["lm_head"]
    else:
        name = "dec_embedding" if g.cfg.family == "encdec" else "embedding"
        path, leaf = (name,), p[name]
    positions = g.tokens if g.step == "train" else 1
    return _matrix_flops(g, path, leaf) * positions


def _last_product(g: _Geometry, lp, kind: str) -> float:
    """The FLOPs a row of a layer's final product, whose output nothing
    saves for the backward (it only joins the residual stream): the
    recomputation of ``"full"`` stops before it (non-reentrant
    checkpoint's early stop, as XLA drops a dead recomputation).  The
    FFN's ``w_out`` (the MoE's shared expert's), an SSD layer's
    ``out_proj``; an MoE layer without a shared expert has none (its
    experts' outputs are weighted by the gates)."""
    N = g.enc_tokens if kind == "enc_attn" else g.tokens
    if "ssd" in lp:
        path, leaf = ("ssd", "out_proj"), lp["ssd"]["out_proj"]
    elif "moe" in lp:
        if "shared" not in lp["moe"]:
            return 0.0
        path, leaf = ("moe", "shared", "w_out"), lp["moe"]["shared"]["w_out"]
    else:
        path, leaf = ("ffn", "w_out"), lp["ffn"]["w_out"]
    return _matrix_flops(g, path, leaf) * N


def step_flops(cell, *, dense_attention: bool = False) -> Dict[str, float]:
    """FLOPs of one device's step, by kind: ``products`` (the layers' and
    the head's products with no batch dimension), ``experts``,
    ``attention`` (K2's, or K1's), ``cross`` (a decoder's plain
    cross-attention), ``ssd``.  Training multiplies each forward count by
    3 (forward and a backward of two products), K2's attention by 3.5 (its
    backward is 2.5 forwards), and adds one forward of the layers with
    ``remat``, but for each layer's last product (``_last_product``);
    ``"dots"`` keeps the products' outputs, so it runs none of them
    again.  ``dense_attention``: count every (query, key) pair (a decode
    step: every slot of the table), as the plain versions on the CPU do."""
    g = _Geometry(cell)
    mm = experts = enc = attn = cross = ssd = last = 0.0
    for grp, lp in _layers(g):
        pf = _product_flops(g, lp, grp.kind)
        mm, experts, enc = mm + pf["mm"], experts + pf["experts"], enc + pf["enc"]
        a, c = _attention_flops(g, lp, grp, dense_attention)
        attn, cross = attn + a, cross + c
        ssd += _ssd_flops(g, lp)
        last += _last_product(g, lp, grp.kind)
    head = _head_flops(g)
    layers_mm = mm + enc
    if g.step == "train":
        extra = 0.0 if not g.remat else 1.0
        again = layers_mm - last if g.remat == "full" else 0.0
        products = 3.0 * layers_mm + again + 3.0 * head
        experts *= 3.0 + extra
        cross *= 3.0 + extra
        ssd *= 3.0 + extra
        attn *= 3.5 + extra
    else:
        products = layers_mm + head
    return {k: v * g.rows for k, v in (("products", products),
                                       ("experts", experts),
                                       ("attention", attn), ("cross", cross),
                                       ("ssd", ssd))}


def cell_flops(cell) -> float:
    """FLOPs of the whole machine for one step: ``step_flops`` summed,
    times the chips."""
    return sum(step_flops(cell).values()) * cell.chips


# --------------------------------------------------------------------------- bytes
def _param_bytes(g: _Geometry, read: bool = False) -> Tuple[float, float]:
    """(bytes, elements) of the parameters one device holds (``read``:
    those the step reads: a decode step reads no encoder)."""
    total = elems = 0.0
    for path, leaf in tree_leaves_with_path(g.params):
        if read and g.step == "decode" and path[:2] == ("groups", "0") \
                and g.cfg.family == "encdec":
            continue
        n = _dev_numel(path, leaf, g.t)
        total += n * leaf.element_size()
        elems += n
    return total, elems


def cell_bytes(cell) -> float:
    """HBM bytes of the whole machine for one step (module doc)."""
    g = _Geometry(cell)
    cfg, el = g.cfg, g.el
    wbytes, welems = _param_bytes(g, read=True)
    head = g.params.get("lm_head", g.params.get(
        "dec_embedding" if cfg.family == "encdec" else "embedding"))
    V = _dev_numel(("lm_head",) if "lm_head" in g.params else ("embedding",),
                   head, g.t) // cfg.d_model
    resid = sum(2.0 * g.rows * cfg.d_model * el
                * (g.enc_tokens if grp.kind == "enc_attn" else g.tokens)
                / _seq_div(cell, grp) for grp, _ in _layers(g))
    if g.step == "train":
        passes = 3 if g.remat == "full" else 2          # forward(s) and dX
        logits = g.rows * g.tokens * V * (el + 4 + 4)
        return cell.chips * (passes * wbytes + 28.0 * welems
                             + (passes + 1) * resid + 2.0 * logits)
    total = wbytes + resid
    state = cell.args[1]
    kv_el = el
    for grp, cache in zip(layer_groups(cfg), state.caches):
        if g.step == "prefill":
            if "k_slabs" in cache or "ring_k" in cache:
                K = cfg.n_kv_heads
                total += (2.0 * g.rows * g.tokens * K * cfg.resolved_head_dim
                          * kv_el * grp.n_layers)
            continue
        if "k_slabs" in cache:
            _, K = _attn_heads(g, _first_layer(g, grp)["attn"])
            total += (2.0 * g.rows * (g.ctx + 1) * K * cfg.resolved_head_dim
                      * kv_el * grp.n_layers)
        for name in ("ring_k", "ring_v", "cross_k", "cross_v", "h", "conv"):
            if name in cache:
                moved = 2 if name in ("h", "conv") else 1     # read + write
                total += moved * _nbytes(cache[name]) / (
                    _row_share(cell.rows, g.data) * _state_div(state, name))
    return cell.chips * total


def _seq_div(cell, grp) -> int:
    """t where sequence parallelism splits the stack of ``grp``'s layers
    (each shard holds 1/t of its residual rows), else 1."""
    stack = "encoder" if grp.kind == "enc_attn" else "decoder"
    return cell.grid.model.n if getattr(cell, "seq_split", {}).get(stack) else 1


def _first_layer(g: _Geometry, grp):
    for group, gp in zip(layer_groups(g.cfg), g.params["groups"]):
        if group == grp:
            return gp[0]
    raise KeyError(grp)


def _state_div(state, name: str) -> int:
    """The model-axis split of a cache held a row, from the decode state's
    layout: the recurrent layers' for ``h`` / ``conv``, the kv heads' for
    rings and cross K/V."""
    lay = state.layout
    return lay.state_split if name in ("h", "conv") else lay.kv_split


# --------------------------------------------------------------------------- wire
def _norm_bytes(lp) -> int:
    """The bytes of a layer's norms' parameters (every block's)."""
    return sum(_nbytes(leaf) for name in ("norm1", "norm_cross", "norm2")
               if name in lp for leaf in lp[name].values())


def _layer_wire(g: _Geometry, lp, kind: str, N: int, el: int,
                sp: bool = False) -> Tuple[int, int, int]:
    """One layer's model-axis slices at N tokens a device, as ``Pods``
    counts them: (forward bytes, backward bytes, the bytes of the layer's
    final psum, which a recomputation does not run again: its output only
    joins the residual stream).  Forward: the
    row-parallel psums [N, D] of a split attention, cross-attention, FFN,
    expert or recurrent block, the MoE's gather of its router logits
    [N, E/t], the SSD's gather of B and C [N, 2 n/t] and psum of the
    norm's sums of squares [N] float32, the RG-LRU's gather of xb
    [N, w/t].  Backward (a training step's ``copy_in``s): each split
    block's input [N, D], the replicated leaves its shards read (``wk`` /
    ``wv`` where the kv heads stay whole, the qk-norm scales, the RG-LRU's
    ``w_r`` / ``w_i``, the SSD's norm scale and its variance [N] float32),
    and a decoder's encoder output [Ne, D] float32 for its cross K/V.

    ``sp`` (sequence parallelism splits this stack): each block's input is
    an all-gather of the shards' rows, forward (1/t of [N, D] a shard),
    whose backward is a reduce-scatter when the block is split and nothing
    when it runs replicated; a split block's output a reduce-scatter
    (backward an all-gather), a replicated one's a chunk (backward an
    all-gather); the norms' scales sum their gradients (``_norm_bytes``);
    the SSD's psum and the MoE's, FFN's and SSD's final ones become the
    reduce-scatter."""
    cfg, t = g.cfg, g.t
    D = cfg.d_model
    row = N * D * el
    chunk = row // t
    fwd = bwd = last = 0
    if sp:
        bwd += _norm_bytes(lp)

    def io(split: bool, final: bool = False):
        """A block's input and output: (fwd, bwd, last) of its psum and
        copy_in, or under ``sp`` of its gather and reduce-scatter."""
        if not sp:
            return (row, row, row if final else 0) if split else (0, 0, 0)
        if split:
            return 2 * chunk, 2 * chunk, chunk if final else 0
        return chunk, chunk, 0

    def shared_bytes(p):
        names = [n for n in ("q_norm", "k_norm") if n in p]
        if p["wk"].dim() == 2:
            names += ["wk", "wv"]
        return sum(_nbytes(p[n]) for n in names)

    def add(f, b, l_=None):
        nonlocal fwd, bwd, last
        fwd, bwd = fwd + f, bwd + b
        if l_ is not None:
            last = l_

    for block in ("attn", "cross"):
        if block in lp:
            split = lp[block]["wq"].dim() == 3
            add(*io(split)[:2])
            if split:
                bwd += shared_bytes(lp[block]) + (
                    g.rows * g.enc_tokens * D * 4 if block == "cross" else 0)
    if "ffn" in lp:
        add(*io(lp["ffn"]["w_in"].dim() == 3, final=True))
    if "moe" in lp:
        p = lp["moe"]
        whole_shared = "shared" in p and p["shared"]["w_in"].dim() == 2
        if p["we_in"].dim() == 4:
            add(*io(True, final=True))
            fwd += N * p["router"].shape[-1] * el
            if sp and whole_shared:   # its output's chunk: an all-gather back
                bwd += chunk
        elif "shared" in p and not whole_shared:
            # a replicated block whose shared expert splits: its psum and
            # copy_in beside the block's gather and chunk
            add(*io(False, final=True))
            add(row, row, row)
        else:
            add(*io(False, final=True))
    if "ssd" in lp:
        if lp["ssd"]["in_proj"].dim() == 3:
            Q = cfg.ssm_chunk
            Np = N if g.step == "decode" else g.rows * (-(-g.tokens // Q) * Q)
            f, b, l_ = io(True, final=True)
            if not sp:               # the input's copy_in is of the padded rows
                b = Np * D * el
            add(f + Np * 2 * cfg.ssm_state // t * el + Np * 4,
                b + _nbytes(lp["ssd"]["norm_scale"]) + Np * 4, l_)
        else:
            add(*io(False, final=True))
    if "rglru" in lp:
        p = lp["rglru"]
        split = p["rg_in"].dim() == 3
        add(*io(split)[:2])
        if split:
            fwd += N * p["rg_in"].shape[-1] * el
            bwd += _nbytes(p["w_r"]) + _nbytes(p["w_i"])
    return fwd, bwd, last


def model_wire(cell) -> int:
    """The model axis's bytes of one step of one device group (a line of
    the model axis), ``Pods``' count: t (t - 1) x each collective's
    per-shard slice.  Decode and prefill: the forward collectives of every
    layer (``_layer_wire``), the vocab-parallel embedding's psum and
    greedy's gathers of each shard's best logit and its index (int64) a
    row.  Training: the forward, the backward's ``copy_in`` sums, one more
    forward of the layers with ``remat`` but for each layer's final psum,
    the head's input, the loss's max, sum of exponentials and target logit
    [N] float32, and the clip's sum of the split gradients' squares (one
    float32).  Where sequence parallelism splits a stack
    (``cell.seq_split``) its layers count as ``_layer_wire(sp=True)``, the
    embedding's psum is a reduce-scatter (a whole embedding's rows a
    chunk; either's backward an all-gather), the final norm's scale sums
    its gradient and its rows are gathered for the head (backward a
    reduce-scatter where the head splits), a prefill gathers each shard's
    last row, and an encoder's final norm is gathered whole."""
    g = _Geometry(cell)
    t, cfg, p = g.t, g.cfg, g.params
    if t == 1:
        return 0
    split = getattr(cell, "seq_split", {})
    sp_dec, sp_enc = split.get("decoder", False), split.get("encoder", False)
    N = g.rows * g.tokens
    el, D = g.el, cfg.d_model
    fwd = bwd = last = 0
    for grp, lp in _layers(g):
        enc = grp.kind == "enc_attn"
        f, b, l_ = _layer_wire(g, lp, grp.kind,
                               g.rows * g.enc_tokens if enc else N,
                               4 if enc else el, sp_enc if enc else sp_dec)
        fwd, bwd, last = fwd + f, bwd + b, last + l_
    train = g.step == "train"
    outer = 0
    emb_split = "embedding" in p and p["embedding"].dim() == 3
    if sp_dec:      # the reduce-scatter forward, or the chunk; backward an all-gather
        outer += N * D * el // t * (emb_split + train)
    elif emb_split:
        outer += N * D * el
    if sp_enc and g.step != "decode":
        outer += g.rows * g.enc_tokens * D * 4 // t   # the encoder's gather
        if train:
            outer += _nbytes(p["enc_norm"]["scale"]) + _nbytes(
                p["enc_norm"]["bias"])
    head = p.get("lm_head", p.get("embedding"))
    head_split = head is not None and head.dim() == 3
    if train:
        layers = fwd + bwd + (fwd - last if g.remat else 0)
        if head_split:
            outer += 3 * N * 4
        if sp_dec:
            chunk = N * D * el // t
            outer += (sum(_nbytes(leaf) for leaf in p["final_norm"].values())
                      + chunk + (chunk if head_split else 0))
        elif head_split:
            outer += N * D * el
        if any(split_leaves(p)):
            outer += 4
        if cell.opts.compress_pod_grads and cell.grid.n > 1:
            outer += 4 * sum(split_leaves(p))    # the int8 leg's scales' pmax
        return t * (t - 1) * (layers + outer)
    if sp_dec and g.step == "prefill":
        outer += g.rows * D * el                     # the shards' last rows
    if head_split:
        outer += g.rows * el + g.rows * 8
    return t * (t - 1) * (fwd + outer)


def cell_wire_bytes(cell) -> Dict[str, float]:
    """Wire bytes of the whole machine for one step, by axis (module
    doc)."""
    grid = cell.grid
    P, d, t = grid.n, grid.data.n, grid.model.n
    out = {"model": float(model_wire(cell) * P * d)}
    if cell.shape.step == "train":
        g = _Geometry(cell)
        grads, elems = _param_bytes(g)
        grads = 4.0 * elems if cell.cfg.param_dtype == torch.float32 else grads
        out["data"] = 2.0 * (d - 1) * grads * P * t
        if cell.opts.compress_pod_grads:
            leaves = len(tree_leaves(g.params))
            out["pod"] = float(P * (P - 1) * (elems + 4 * leaves) * d * t)
        else:
            out["pod"] = 2.0 * (P - 1) * grads * d * t
    elif cell.opts.coherence != "none" and P > 1:
        buf = 13 * MUTATION_BUDGET                  # table, idx, value, ok
        if cell.opts.coherence == "numapte":
            buf += 4 * MISS_BUDGET * (1 + 2 ** PREFETCH_DEGREE)
        out["pod"] = float(P * (P - 1) * buf * d * t)
    if _sp_decode(cell):
        out["pod"] = out.get("pod", 0.0) + float(sp_combine_wire(cell) * d * t)
    return out


def _sp_decode(cell) -> bool:
    """Whether the cell's decode step is sequence-parallel over the pods
    (``build_cell``: fewer rows than pools)."""
    data_size = cell.grid.n * cell.grid.data.n
    return cell.shape.step == "decode" and cell.rows < data_size \
        and cell.grid.n > 1


def sp_combine_wire(cell) -> int:
    """The pod axis's bytes of one sequence-parallel decode step of one
    device's line of it, ``Pods``' count: in each global attention layer
    ``sp_combine`` of the device's heads over the P pods, a ``pmax`` of the
    partials' log-sum-exps [B, Hs] and two ``psum``s, of the weights
    [B, Hs] and the weighted outputs [B, Hs, hd], all float32 (Hs: the
    device's query heads, H / t where the model axis splits them)."""
    if not _sp_decode(cell):
        return 0
    g = _Geometry(cell)
    P, hd = cell.grid.n, g.cfg.resolved_head_dim
    total = 0
    for grp, lp in _layers(g):
        if grp.kind in ("attn", "dec_attn") and grp.window is None:
            H, _ = _attn_heads(g, lp["attn"])
            total += g.rows * H * (4 + 4 + 4 * hd)
    return P * (P - 1) * total


# --------------------------------------------------------------------------- resident bytes
def device_bytes(cell) -> float:
    """The bytes one device holds of the cell's arguments, counted from the
    config's widths (``per_device_bytes`` sums the built tensors): the
    parameters (a split leaf's slice, from the rules' ``param_shardings``
    of the unsharded tree), AdamW's two float32 moments and its step, the
    batch's rows, and the decode state: the paged slabs' pool, the rings,
    recurrent states and cross K/V of the device's rows, the tables and
    tokens, the prologue's buffers."""
    cfg, grid, shape = cell.cfg, cell.grid, cell.shape
    t, P = grid.model.n, grid.n
    data_size = P * grid.data.n
    rows = cell.rows
    rs = _row_share(rows, data_size)
    whole = init_params(cfg, SHAPES_ONLY)
    n_params = sum(tree_leaves(tree_map(
        lambda leaf, shard: leaf.numel() / (t if shard is not None else 1),
        whole, param_shardings(whole, grid, cfg))))
    pel = torch.tensor([], dtype=cfg.param_dtype).element_size()
    total = n_params * pel
    el = torch.tensor([], dtype=cfg.dtype).element_size()
    S, D = shape.seq_len, cfg.d_model
    enc = cfg.family == "encdec"
    if shape.step == "train":
        total += 4 + 2 * 4 * n_params
        if enc:
            total += rows * (S * D * 2 + (cfg.max_decoder_len + 1) * 4) / rs
        else:
            total += rows * (S + 1) * 4 / rs
        if cell.opts.compress_pod_grads and P > 1:
            total += 4 * n_params
        return total
    geo = dataclasses.replace(shape, global_batch=rows)
    n_frames, mb, n_pools = _decode_geometry(cfg, geo, data_size)
    kv, rec = kv_split(cfg, grid), state_split(cell.args[0], grid)
    hd, K, bt = cfg.resolved_head_dim, cfg.n_kv_heads, cfg.kv_block_tokens
    W1 = cfg.conv_width - 1
    for grp in layer_groups(cfg):
        L = grp.n_layers
        if grp.kind == "ssd":
            total += L * rows * (cfg.ssm_n_heads * cfg.ssm_state
                                 * cfg.ssm_head_dim * 4
                                 + W1 * (cfg.d_inner + 2 * cfg.ssm_state) * el
                                 ) / rs / rec
        elif grp.kind == "rglru":
            w = cfg.lru_width or D
            total += L * rows * (w * 4 + W1 * w * el) / rs / rec
        elif grp.kind in ("attn", "dec_attn") and grp.window is None:
            total += 2 * L * n_frames * bt * K * hd * el / n_pools / kv
            if grp.kind == "dec_attn":
                total += 2 * L * rows * S * K * hd * el / rs / kv
        elif grp.kind == "attn":
            total += 2 * L * rows * grp.window * K * hd * el / rs / kv
    total += rows * 4 / rs                                  # seq_lens
    sp = shape.step == "decode" and rows < data_size
    if shape.step == "prefill":
        total += rows * mb * 4 / rs
        total += (rows * (S * D * 2 + cfg.max_decoder_len * 4) / rs if enc
                  else rows * S * 4 / rs)
        return total
    total += rows * 4 / (1 if sp else rs)
    total += rows * mb * 4 / (n_pools if sp else rs)
    if cell.opts.coherence != "none" and P > 1:
        T = max(1, -(-n_frames // TABLE_ENTRIES))
        total += T * TABLE_ENTRIES * 4 + T * 8 + T * 4
        total += MUTATION_BUDGET * 13 + MISS_BUDGET * 4
    return total


# --------------------------------------------------------------------------- roofline
def mesh_name(cell) -> str:
    grid = cell.grid
    name = (f"pod{grid.n}x{grid.data.n}x{grid.model.n}" if grid.n > 1
            else f"pod{grid.data.n}x{grid.model.n}")
    tag = cell.opts.tag()
    return name if tag == "base" else f"{name}__{tag}"


def roofline(cell) -> Roofline:
    """The three terms of ``cell`` from the analytic counts."""
    flops = cell_flops(cell)
    hbytes = cell_bytes(cell)
    wire = cell_wire_bytes(cell)
    chips = cell.chips
    coll = sum(wire.values())
    return Roofline(arch=cell.arch, shape=cell.shape.name,
                    mesh=mesh_name(cell), chips=chips, flops=flops,
                    bytes=hbytes, collective_bytes=coll,
                    model_flops=model_flops(cell.cfg, cell.shape),
                    compute_s=flops / (chips * PEAK_FLOPS),
                    memory_s=hbytes / (chips * HBM_BW),
                    collective_s=coll / (chips * LINK_BW),
                    per_device_bytes=per_device_bytes(cell),
                    collectives=wire)


def summary(r: Roofline) -> str:
    """The reference's one-line summary of a cell."""
    fit = "fits" if r.fits else "does not fit 80 GB"
    return (f"[{r.arch} x {r.shape} x {r.mesh}] "
            f"flops {r.flops:.3e} bytes {r.bytes:.3e} "
            f"coll {r.collective_bytes:.3e} | "
            f"terms c={r.compute_s * 1e3:.2f}ms m={r.memory_s * 1e3:.2f}ms "
            f"x={r.collective_s * 1e3:.2f}ms -> {r.dominant} | "
            f"roofline_frac {r.roofline_fraction:.3f} | "
            f"{r.per_device_bytes / 1e9:.2f} GB a device, {fit}")


# --------------------------------------------------------------------------- peak
def _widest(g: _Geometry, lp, N: int, sp: int = 1) -> float:
    """The most bytes a layer's forward holds at once at N tokens a device:
    its input and the norm's output (``sp`` = t where sequence parallelism
    splits them: 1/t of each, beside the gathered rows), and the
    attention's q, k, v, the rotated q and k, K2's float32 output and its
    cast, or the FFN's two input products, the activation's temporary and
    its output (the experts': their capacity slots)."""
    cfg, el, hd = g.cfg, g.el, g.cfg.resolved_head_dim
    D = cfg.d_model
    attn = ffn = 0.0
    if "attn" in lp:
        H, K = _attn_heads(g, lp["attn"])
        attn = N * ((2 * H + 3 * K) * hd * el + H * hd * (4 + el))
    if "ffn" in lp:
        F = _dev_numel(("ffn", "w_in"), lp["ffn"]["w_in"], g.t) // D
        ffn = 4 * N * F * el
    if "moe" in lp:
        p = lp["moe"]
        C = expert_capacity(N, cfg.n_experts, cfg.experts_per_token,
                            cfg.moe_capacity_factor)
        F = p["we_in"].shape[-1]
        E = _dev_numel(("moe", "we_in"), p["we_in"], g.t) // (D * F)
        ffn = E * C * (D + 3 * F) * el
    if "ssd" in lp or "rglru" in lp:
        name = "ssd" if "ssd" in lp else "rglru"
        leaf = lp[name]["in_proj" if name == "ssd" else "rg_in"]
        ffn = max(ffn, 3 * N * _dev_numel((name, "x"), leaf, g.t) // D * 4)
    rows = 2 * N * D * el if sp == 1 else 2 * N * D * el / sp + N * D * el
    return rows + max(attn, ffn)


def _saved_dots(g: _Geometry, lp, N: int) -> float:
    """The outputs of a layer's products (``cfg.dtype``) at N tokens a
    device, which ``"dots"`` keeps for the backward."""
    total = 0.0
    for block in ("attn", "cross", "ffn", "rglru", "ssd"):
        for name, leaf in lp.get(block, {}).items():
            split = _split((block, name), leaf)
            if leaf.dim() - int(split) < 2 or name == "conv_w":
                continue
            total += N * _dev_numel((block, name), leaf, g.t) / leaf.shape[-2]
    return total * g.el


def peak_bytes(cell) -> float:
    """The analytic peak of one device's step: its arguments
    (``device_bytes``) and, beside them, the largest weight's cast to
    ``cfg.dtype`` and the widest layer (``_widest``); the head's logits
    (``cfg.dtype``, float32) of the positions it reads; and for a train
    step the gradients (the parameters' dtype), each layer's saved input
    (``remat``, 1/t of it where sequence parallelism splits the stack;
    ``"dots"`` also its products' outputs; without remat every layer holds
    about three widest points),
    the head's logits, their float32 log-softmax and its gradient (14
    bytes a logit), or at the step's end every gradient with the last
    layer's recomputation and its backward (twice its widest point) or
    AdamW's four float32 temporaries of the largest leaf."""
    g = _Geometry(cell)
    cfg, el = g.cfg, g.el
    resident = device_bytes(cell)
    N = g.rows * g.tokens
    head = g.params.get("lm_head", g.params.get(
        "dec_embedding" if cfg.family == "encdec" else "embedding"))
    V = head.numel() // cfg.d_model // (g.t if head.dim() == 3 else 1)
    wmax = max(_dev_numel(path, leaf, g.t) for path, leaf in
               tree_leaves_with_path(g.params)) * el
    widest = max(_widest(g, lp, g.rows * (g.enc_tokens if grp.kind == "enc_attn"
                                          else g.tokens), _seq_div(cell, grp))
                 for grp, lp in _layers(g))
    if g.step != "train":
        return resident + wmax + widest + g.rows * V * (el + 4)
    _, elems = _param_bytes(g)
    grads = elems * torch.tensor([], dtype=cfg.param_dtype).element_size()
    saved = sum(N * cfg.d_model * el / _seq_div(cell, grp)
                + (_saved_dots(g, lp, N) if g.remat == "dots" else 0)
                if g.remat else 3 * widest for grp, lp in _layers(g))
    adamw = 4 * 4 * wmax / el
    return resident + saved + wmax + max(14.0 * N * V,
                                         grads + max(2 * widest, adamw))
