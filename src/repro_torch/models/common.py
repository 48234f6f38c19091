"""Shared model machinery: configs, layer groups, norms, RoPE, init.

Heterogeneous layer stacks are represented as *runs of identical layers*
(``layer_groups``); the port executes a run as a Python loop over its layers.
"""
from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

PyTree = Any


# --------------------------------------------------------------------------- config
@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # attention options
    qk_norm: bool = False
    local_window: Optional[int] = None       # window for 'local' layers
    local_global_ratio: Optional[Tuple[int, int]] = None  # e.g. (5, 1)
    rope_theta: float = 10_000.0
    rope_theta_global: Optional[float] = None
    attn_logit_softcap: Optional[float] = None
    # ffn
    ffn_act: str = "silu"                    # silu | geglu | gelu | relu2
    # moe
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    first_dense_layers: int = 0              # kimi: leading dense layers
    moe_capacity_factor: float = 1.25
    # ssm (mamba2 SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    conv_width: int = 4
    expand: int = 2
    # hybrid (recurrentgemma)
    recurrent_ratio: Optional[Tuple[int, int]] = None   # (n_recurrent, n_attn)
    lru_width: Optional[int] = None
    # enc-dec (whisper)
    n_encoder_layers: int = 0
    n_decoder_layers: int = 0
    max_decoder_len: int = 448
    use_rope: bool = True
    norm: str = "rmsnorm"                    # rmsnorm | layernorm
    tie_embeddings: bool = True
    # numerics
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    # serving
    kv_block_tokens: int = 16
    # sub-quadratic? (drives long_500k eligibility)
    sub_quadratic: bool = False
    # per-arch logical->mesh rule overrides of the multi-device layer; kept
    # so a config compares field for field with the JAX package's
    rule_overrides: Tuple[Tuple[str, Any], ...] = ()
    # --- the port's own fields, after the reference's (none of the ten
    # configs sets them): multi-head latent attention (DeepSeek-V3's MLA,
    # on when kv_lora_rank > 0) and the experts' router
    kv_lora_rank: int = 0                    # the cached latent's width
    qk_nope_head_dim: int = 0                # a head's query/key width without RoPE
    qk_rope_head_dim: int = 0                # the RoPE width, one key shared by the heads
    v_head_dim: int = 0
    moe_router: str = "softmax"              # softmax | sigmoid (top-k on score + bias)
    moe_routed_scale: float = 1.0            # the routed experts' gates times this
    moe_dropless: bool = False               # no capacity: no assignment ever drops
    f32_residual: bool = False               # the residual stream in float32

    @property
    def mla(self) -> bool:
        """Whether attention is multi-head latent attention."""
        return self.kv_lora_rank > 0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model   # mamba2 inner width

    @property
    def ssm_n_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim


@dataclasses.dataclass(frozen=True)
class LayerGroup:
    """A run of structurally identical layers."""
    kind: str                 # attn | ssd | rglru | enc_attn | dec_attn
    n_layers: int
    window: Optional[int] = None      # None = global attention
    moe: bool = False
    rope_theta: float = 10_000.0


def layer_groups(cfg: ModelConfig) -> List[LayerGroup]:
    """Derive the run-length-encoded layer pattern from the config."""
    if cfg.family == "ssm":
        return [LayerGroup("ssd", cfg.n_layers)]
    if cfg.family == "encdec":
        return [LayerGroup("enc_attn", cfg.n_encoder_layers),
                LayerGroup("dec_attn", cfg.n_decoder_layers)]
    kinds: List[Tuple[str, Optional[int], bool, float]] = []
    for i in range(cfg.n_layers):
        if cfg.family == "hybrid" and cfg.recurrent_ratio:
            r, a = cfg.recurrent_ratio
            if i % (r + a) < r:
                kinds.append(("rglru", None, False, cfg.rope_theta))
                continue
            kinds.append(("attn", cfg.local_window, False, cfg.rope_theta))
            continue
        window: Optional[int] = None
        theta = cfg.rope_theta
        if cfg.local_global_ratio:
            loc, glob = cfg.local_global_ratio
            if (i % (loc + glob)) < loc:
                window = cfg.local_window
            else:
                theta = cfg.rope_theta_global or cfg.rope_theta
        moe = (cfg.n_experts > 0) and (i >= cfg.first_dense_layers)
        kinds.append(("attn", window, moe, theta))
    groups: List[LayerGroup] = []
    for kind, window, moe, theta in kinds:
        if (groups and groups[-1].kind == kind and groups[-1].window == window
                and groups[-1].moe == moe and groups[-1].rope_theta == theta):
            groups[-1] = dataclasses.replace(groups[-1],
                                             n_layers=groups[-1].n_layers + 1)
        else:
            groups.append(LayerGroup(kind, 1, window, moe, theta))
    assert sum(g.n_layers for g in groups) == cfg.n_layers or cfg.family == "encdec"
    return groups


def require_ported(cfg: ModelConfig) -> List[LayerGroup]:
    """The layer groups of ``cfg``.  Every part of the reference's configs
    is ported: attention with global, windowed or no RoPE and the logit
    soft-cap (``attn_logit_softcap``, on every attention path: K1, K2 and
    its backward, the ring decode, cross-attention, sequence-parallel
    decode); dense and mixture-of-experts FFNs; SSD; RG-LRU; the
    encoder-decoder.  A negative cap raises a ValueError."""
    if cfg.attn_logit_softcap is not None and cfg.attn_logit_softcap < 0:
        raise ValueError(f"{cfg.name}: attn_logit_softcap "
                         f"{cfg.attn_logit_softcap}: a cap is positive")
    return layer_groups(cfg)


@dataclasses.dataclass(frozen=True)
class CacheLayout:
    """How a decode state holds its caches, recorded once where
    ``init_decode_state`` makes them (no cache's layout is read off its
    rank): ``pools`` P KV pools of the paged slabs, ``kv_split`` t model
    shards splitting the kv heads of the slabs, rings and cross K/V (1:
    held once, replicated over the model axis), ``state_split`` model
    shards splitting the recurrent states.  One layer's paged slab is
    ``[N, bt, K, hd]``, pooled ``[P, N/P, bt, K, hd]``, split ``[t, N, bt,
    K/t, hd]``, or both ``[t, P, N/P, bt, K/t, hd]`` (shard i's pools one
    contiguous K1 operand once flattened); a ring or cross K/V ``[B, ...,
    K, hd]`` or ``[t, B, ..., K/t, hd]``; ``h`` and ``conv`` ``[B, ...]``
    or ``[t, B, ...]``.  A tree of the port holds it as structure, not as
    a leaf (``_tree``)."""
    _tree_static = True

    pools: int = 1
    kv_split: int = 1
    state_split: int = 1

    @property
    def split(self) -> bool:
        """Whether the kv heads are split over the model axis."""
        return self.kv_split > 1

    def shard_slab(self, slab: torch.Tensor, i: int) -> torch.Tensor:
        """Local shard ``i``'s operand of one layer's paged slab (the whole
        slab where the kv heads are not split), its pools flattened:
        ``[N, bt, K or K/t, hd]``, a view."""
        if self.split:
            slab = slab[i]
        return slab.flatten(0, 1) if self.pools > 1 else slab

    def row_dim(self, name: str) -> int:
        """The batch dimension of one layer's cache held a row (``ring_*``,
        ``cross_*``, ``h``, ``conv``), after any model-shard lead."""
        split = self.state_split if name in ("h", "conv") else self.kv_split
        return int(split > 1)

    def pool_dim(self) -> int:
        """The pool dimension of one layer's pooled slab."""
        return int(self.split)


# --------------------------------------------------------------------------- prims
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * (1 + scale), computed in float32."""
    out = F.rms_norm(x.float(), x.shape[-1:], 1.0 + scale.float(), eps)
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) * scale + bias, computed in float32."""
    out = F.layer_norm(x.float(), x.shape[-1:], scale.float(), bias.float(), eps)
    return out.to(x.dtype)


def apply_norm(cfg: ModelConfig, x: torch.Tensor, p: Dict[str, torch.Tensor]
               ) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"])


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each [..., seq, 1, head_dim/2] float32, for positions
    [..., seq].  They depend on neither the layer nor the tensor rotated, so
    a forward pass makes them once per layer group."""
    freqs = rope_frequencies(head_dim, theta, positions.device)  # [hd/2]
    angles = positions[..., None].float() * freqs                # [..., seq, hd/2]
    angles = angles[..., None, :]                                # broadcast heads
    return torch.cos(angles), torch.sin(angles)


def rotate(x: torch.Tensor, rope: Tuple[torch.Tensor, torch.Tensor]
           ) -> torch.Tensor:
    """Split-halves rotation of x [..., seq, heads, head_dim] by ``rope``
    (from ``rope_tables``), computed in float32."""
    cos, sin = rope
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    return rotate(x, rope_tables(positions, x.shape[-1], theta))


def activation(name: str, x: torch.Tensor, gate: Optional[torch.Tensor]
               ) -> torch.Tensor:
    if name == "silu":
        return F.silu(gate) * x
    if name == "geglu":
        return F.gelu(gate, approximate="tanh") * x
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "relu2":                       # nemotron squared-ReLU
        return torch.square(F.relu(x))
    raise ValueError(f"unknown activation {name}")


def ffn_has_gate(name: str) -> bool:
    return name in ("silu", "geglu")


# --------------------------------------------------------------------------- init
#: a stand-in for a generator that makes every parameter an empty tensor on
#: the meta device: ``init_params(cfg, SHAPES_ONLY)`` gives shapes and dtypes
#: and allocates nothing (a trillion-parameter config is counted this way)
SHAPES_ONLY = SimpleNamespace(device=torch.device("meta"))


def _dense(gen: torch.Generator, shape: Sequence[int], dtype,
           scale: float = 1.0) -> torch.Tensor:
    """Normal(0, scale / sqrt(fan_in)), drawn in float32 on the generator's
    device and stored as ``dtype``.  fan_in is ``shape[0]``, as the
    reference takes it.  A stacked tensor (three axes or more: the experts)
    is drawn one leading slice at a time, so that the float32 temporary is
    one slice and never the whole tensor."""
    if gen.device.type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    fan_in = shape[0] if len(shape) > 1 else 1
    std = scale / math.sqrt(fan_in)

    def draw(s: Sequence[int]) -> torch.Tensor:
        out = torch.randn(tuple(s), generator=gen, dtype=torch.float32,
                          device=gen.device)
        return out.mul_(std).to(dtype)

    if len(shape) < 3:
        return draw(shape)
    out = torch.empty(tuple(shape), dtype=dtype, device=gen.device)
    for i in range(shape[0]):
        out[i] = draw(shape[1:])
    return out


def init_norm(cfg: ModelConfig, d: int, dtype, device) -> Dict[str, torch.Tensor]:
    if cfg.norm == "layernorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}
