"""Logical-axis sharding: models name axes, rules map them to grid axes.

The port's copy of the reference's logical-axis rules
(``src/repro/distributed/sharding.py``).  Model code never mentions grid
axes; parameters and activations carry logical names ('batch', 'heads',
'ff', 'vocab', ...), and a ``ShardingRules`` table maps each name to a grid
axis per deployment:

  * single-pod (16, 16) ('data', 'model')
  * multi-pod (2, 16, 16) ('pod', 'data', 'model') — 'pod' joins the batch
    dimension (pure DP + the numaPTE coherence domain).

A spec is a tuple with one entry a dimension: ``None`` (replicated), an axis
name, or a tuple of axis names — the reference's ``PartitionSpec``.

The reference's ``constrain`` has no counterpart here: it is a layout hint
to XLA's partitioner, which then inserts the collectives.  The port runs
eagerly, so its tensor-parallel layers issue their collectives themselves
(``repro_torch.models``: a ``copy_in`` at each column-parallel input, a
``psum`` over ``model`` at each row-parallel output).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Sequence, Tuple, Union

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Map logical axis name -> grid axis (or tuple of grid axes)."""
    rules: Tuple[Tuple[str, Axis], ...]

    def lookup(self, logical: Optional[str]) -> Axis:
        if logical is None:
            return None
        for name, target in self.rules:
            if name == logical:
                return target
        return None

    def spec(self, logical_axes: Sequence[Optional[str]]) -> Spec:
        return tuple(self.lookup(a) for a in logical_axes)


#: single-pod production grid ('data', 'model')
SINGLE_POD_RULES = ShardingRules(rules=(
    ("batch", "data"),
    ("seq", None),
    ("act_seq", None),      # Megatron-SP maps this to 'model'
    ("seq_sp", "data"),        # sequence-parallel prefill
    ("embed", None),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("head_dim", None),
    ("ff", "model"),
    ("vocab", "model"),
    ("experts", "model"),
    ("expert_ff", None),
    ("blocks", "data"),        # KV slab pool
    ("pod", None),
))

#: multi-pod production grid ('pod', 'data', 'model')
MULTI_POD_RULES = ShardingRules(rules=(
    ("batch", ("pod", "data")),
    ("seq", None),
    ("act_seq", None),
    ("seq_sp", "data"),
    ("embed", None),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("head_dim", None),
    ("ff", "model"),
    ("vocab", "model"),
    ("experts", "model"),
    ("expert_ff", None),
    ("blocks", "data"),
    ("pod", "pod"),
))

#: FSDP-style variant: parameters additionally sharded over 'data' on their
#: longest non-model axis (ZeRO-3); used by the kimi-scale configs.
FSDP_EXTRA_AXES = ("embed", "expert_ff")

_state = threading.local()


def current_rules() -> ShardingRules:
    return getattr(_state, "rules", SINGLE_POD_RULES)


@contextlib.contextmanager
def use_rules(rules: ShardingRules):
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield rules
    finally:
        if prev is None:
            del _state.rules
        else:
            _state.rules = prev


def logical_spec(*logical_axes: Optional[str]) -> Spec:
    return current_rules().spec(logical_axes)


def param_pspec(path: Tuple[str, ...], shape: Tuple[int, ...]) -> Spec:
    """Sharding spec for one parameter from its tree path + shape, by its
    leaf name under the current rules: e.g. 'wq' has shape [embed,
    heads*head_dim] -> (None, 'model').  Norms, biases and other small
    vectors are replicated: ()."""
    leaf = path[-1]
    rules = current_rules()
    m = rules.lookup("heads")
    f = rules.lookup("ff")
    v = rules.lookup("vocab")
    e = rules.lookup("experts")
    table = {
        # attention
        "wq": (None, m), "wk": (None, m), "wv": (None, m), "wo": (m, None),
        # dense ffn
        "w_in": (None, f), "w_gate": (None, f), "w_out": (f, None),
        # embeddings / head
        "embedding": (v, None), "lm_head": (None, v),
        # moe: experts dim sharded
        "we_in": (e, None, None), "we_gate": (e, None, None),
        "we_out": (e, None, None), "router": (None, e),
        # mamba / rglru big projections
        "in_proj": (None, f), "out_proj": (f, None),
        "conv_w": (None, f), "conv_b": (f,),
        "a_log": (f,), "dt_bias": (f,), "d_skip": (f,),
        "rg_a": (f,), "rg_in": (None, f), "rg_gate": (None, f),
    }
    return table.get(leaf, ())
