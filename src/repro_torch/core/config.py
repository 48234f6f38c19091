"""Declarative simulator configuration: ``SimConfig`` + ``make_sim``.

The simulator grew one knob at a time — ``NumaSim(policy=, contention=,
settle_engine=, ...)``, ``apply_mm_ops(engine=, concurrency=, settle=)``,
``run_app(engine=)`` — and every benchmark re-plumbed the same arguments
through its own signature.  ``SimConfig`` consolidates the full knob
surface into one frozen dataclass; ``make_sim`` is the factory that turns
(topology, config) into a ready ``NumaSim``.

String registries make configs serializable (CLI flags, JSON bench
configs) without importing enum/class internals:

* ``policy`` — a :class:`~repro_torch.core.pagetable.Policy` or a name in
  :data:`POLICIES` (``"linux"``, ``"mitosis"``, ``"numapte"``);
* ``contention`` — ``None`` (no ambient model), a name in
  :data:`~repro_torch.core.shootdown.CONTENTION_MODELS` (``"null"``,
  ``"queue"``, ``"coalescing"``, ``"hardware"``), or a model instance
  whose class is registered (or subclasses a registered model — anything
  else raises the same ``ValueError`` as an unknown name).  A name is
  instantiated fresh per ``make_sim`` call so two sims never share busy
  horizons by accident; pass an instance to share deliberately.

``engine``/``concurrency``/``settle`` become the sim-wide defaults that
``apply_mm_ops`` and the workload phases consult, so call sites no longer
thread them through every signature.  The legacy kwargs still work but
emit :class:`DeprecationWarning` (see ``NumaSim.__init__`` /
``apply_mm_ops``).
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Optional, Tuple, Union

from .costmodel import CostModel
from .pagetable import Policy
from .shootdown import CONTENTION_MODELS, ContentionModel, make_contention
from .shootdown_batch import SETTLE_MODES
from .tlb import DEFAULT_TLB_ENTRIES

__all__ = ["ENGINES", "POLICIES", "SimConfig", "make_sim"]

#: string registry for :attr:`SimConfig.policy` (same pattern as
#: ``repro_torch.core.shootdown.CONTENTION_MODELS``)
POLICIES = {
    "linux": Policy.LINUX,
    "mitosis": Policy.MITOSIS,
    "numapte": Policy.NUMAPTE,
}

#: mm-op execution engines: the vectorized batch engine, the
#: whole-trace compiled windowed executor (``repro_torch.core.trace``) and the
#: scalar per-op reference loop (all byte-identical; the differential
#: suites are the proof)
ENGINES = ("batch", "trace", "scalar")


# sentinel distinguishing "kwarg omitted" from any legal explicit value,
# so deprecated kwargs warn only when actually used
_UNSET = object()


def _warn_deprecated(old: str, new: str) -> None:
    warnings.warn(f"{old} is deprecated; use {new}",
                  DeprecationWarning, stacklevel=3)


@dataclass(frozen=True)
class SimConfig:
    """Every simulator knob in one immutable value.

    Construction/runtime knobs (consumed by ``NumaSim.__init__``):
    ``policy``, ``prefetch_degree``, ``tlb_filter``, ``cost``,
    ``tlb_entries``, ``interference_nodes``, ``contention``, ``settle``.

    Batching defaults (consumed by ``apply_mm_ops`` and the workload
    phases when the call site doesn't say otherwise): ``engine``,
    ``concurrency``.

    ``elide_flushes`` turns on lazy TLB invalidation for the unmap paths
    ("Skip TLB flushes for reused pages", arXiv 2409.10946): ``munmap``
    and ``madvise_dontneed`` mark still-cached translations as stale per
    process instead of issuing an IPI round, and the deferred flush is
    forced — charged through the contention models like any other round
    — only when a marked page is remotely touched, has its protections
    tightened, or its frame is remapped to a *different* process (see
    ``NumaSim._force_deferred_flush``).  ``False`` (the default) is
    byte-identical to the classic engines.
    """

    policy: Union[Policy, str] = Policy.NUMAPTE
    prefetch_degree: int = 0
    tlb_filter: bool = True
    cost: Optional[CostModel] = None
    tlb_entries: int = DEFAULT_TLB_ENTRIES
    interference_nodes: Tuple[int, ...] = ()
    contention: Union[None, str, ContentionModel] = None
    settle: str = "auto"
    engine: str = "batch"
    concurrency: str = "sequential"
    elide_flushes: bool = False

    def __post_init__(self):
        from .mm_batch import CONCURRENCY_MODES
        if isinstance(self.policy, str):
            if self.policy not in POLICIES:
                raise ValueError(f"unknown policy {self.policy!r}; "
                                 f"pick from {sorted(POLICIES)}")
        elif not isinstance(self.policy, Policy):
            raise TypeError(f"policy must be a Policy or one of "
                            f"{sorted(POLICIES)}, got {self.policy!r}")
        if isinstance(self.contention, str):
            if self.contention not in CONTENTION_MODELS:
                raise ValueError(f"unknown contention {self.contention!r}; "
                                 f"pick from {sorted(CONTENTION_MODELS)}")
        elif self.contention is not None and not isinstance(
                self.contention, tuple(CONTENTION_MODELS.values())):
            # instances get the same clear error as unknown names: an
            # unregistered model class would otherwise leak into the
            # engines with settlement semantics nothing ever validated
            # (subclasses of a registered model are fine — they inherit
            # validated semantics)
            raise ValueError(
                f"unknown contention model "
                f"{type(self.contention).__name__!r}; pick from "
                f"{sorted(CONTENTION_MODELS)} (or subclass one)")
        if self.settle not in SETTLE_MODES:
            raise ValueError(f"unknown settle {self.settle!r}; "
                             f"pick from {SETTLE_MODES}")
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}; "
                             f"pick from {ENGINES}")
        if self.concurrency not in CONCURRENCY_MODES:
            raise ValueError(f"unknown concurrency {self.concurrency!r}; "
                             f"pick from {CONCURRENCY_MODES}")
        if not isinstance(self.elide_flushes, bool):
            raise TypeError(f"elide_flushes must be a bool, "
                            f"got {self.elide_flushes!r}")
        # tuple-ify so configs hash/compare by value even when built with
        # a list (frozen dataclass => go through object.__setattr__)
        if not isinstance(self.interference_nodes, tuple):
            object.__setattr__(self, "interference_nodes",
                               tuple(self.interference_nodes))

    def replace(self, **changes) -> "SimConfig":
        """A copy with ``changes`` applied (``dataclasses.replace``)."""
        return dataclasses.replace(self, **changes)

    def resolved_policy(self) -> Policy:
        return POLICIES[self.policy] if isinstance(self.policy, str) \
            else self.policy

    def resolved_contention(self) -> Optional[ContentionModel]:
        """Instantiate a registry name; pass instances/None through."""
        if isinstance(self.contention, str):
            return make_contention(self.contention)
        return self.contention


def make_sim(topology, config: Optional[SimConfig] = None, **overrides):
    """Build a :class:`~repro_torch.core.sim.NumaSim` from a :class:`SimConfig`.

    ``overrides`` are per-call field replacements, so one base config can
    stamp out variants::

        base = SimConfig(policy="numapte", prefetch_degree=9)
        sim = make_sim(PAPER_8SOCKET, base, concurrency="overlap")
    """
    cfg = config if config is not None else SimConfig()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    from .sim import NumaSim
    return NumaSim(topology, config=cfg)
