"""The one traffic generator: it reads a mix's parameters
(``perfbench/traffic/<name>.json``) and makes the run's requests from the
seed.

A mix's file holds:

* ``batch``: rows a wave; ``prompt_len`` and ``gen_len``: tokens a request;
* ``arrivals``: ``"backlog"`` (every request queued before the window: the
  server never waits for work) or ``"poisson"`` (an open loop at
  ``rate_per_s``, from ``lead_in_s`` seconds before the window);
* ``kv_frames``: KV frames of the pool, what one full wave needs at its
  longest (``batch`` x the blocks a row holds, one spare block a row);
* ``check_requests``: finished requests the reference compares;
* ``trace_decode_steps``: decode steps the profiler covers after one
  prefill in a traced run.

How the seed is used: a request's prompt is drawn from (seed, request
index), so one seed gives the same prompts.  An open loop's arrival times
keep the same work for every seed: the lead-in and the window each get
``round(rate x length)`` requests, and their gaps are one fixed set, the
exponential distribution's quantiles at (i + 1/2) / n scaled to the
segment's length, in an order the seed draws.  So seeds differ in how the
arrivals cluster, never in how many there are or what each asks for.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"
REQUIRED = ("arrivals", "batch", "prompt_len", "gen_len", "kv_frames",
            "check_requests", "trace_decode_steps")


@dataclasses.dataclass
class Request:
    rid: int
    due: float                      # seconds from the schedule's origin
    prompt: np.ndarray              # [prompt_len] int64 token ids
    gen_len: int
    admitted: Optional[float] = None
    row: int = -1                   # its row in the wave that served it
    token_times: List[float] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)


def load(name: str, directory: Path = TRAFFIC_DIR) -> Dict:
    path = directory / f"{name}.json"
    mix = json.loads(path.read_text())
    missing = [k for k in REQUIRED if k not in mix]
    if missing:
        raise ValueError(f"{path}: missing {missing}")
    if mix["arrivals"] not in ("backlog", "poisson"):
        raise ValueError(f"{path}: arrivals {mix['arrivals']!r}")
    if mix["arrivals"] == "poisson" and not (
            mix.get("rate_per_s", 0) > 0 and mix.get("lead_in_s", -1) >= 0):
        raise ValueError(f"{path}: an open loop needs rate_per_s and lead_in_s")
    return mix


def lead_in(mix: Dict) -> float:
    """Seconds the schedule runs before the window opens."""
    return float(mix.get("lead_in_s", 0.0)) if mix["arrivals"] == "poisson" else 0.0


def prompt(mix: Dict, vocab: int, seed: int, rid: int) -> np.ndarray:
    rng = np.random.default_rng([seed, rid])
    return rng.integers(0, vocab, mix["prompt_len"], dtype=np.int64)


def quantile_gaps(n: int, length: float) -> np.ndarray:
    """n gaps of the exponential distribution's quantiles at (i + 1/2) / n,
    scaled to sum to ``length``."""
    q = -np.log1p(-(np.arange(n) + 0.5) / n)
    return q * (length / q.sum())


def arrival_times(mix: Dict, seed: int, seconds: float) -> np.ndarray:
    """Due times of an open loop, from the origin: the lead-in's requests
    in [0, lead_in), then the window's in [lead_in, lead_in + seconds)."""
    rng = np.random.default_rng([seed, 1 << 20])
    rate, pre = float(mix["rate_per_s"]), lead_in(mix)
    times = []
    for start, length in ((0.0, pre), (pre, float(seconds))):
        n = int(round(rate * length))
        if n == 0:
            continue
        gaps = rng.permutation(quantile_gaps(n, length))
        times.append(start + np.concatenate([[0.0], np.cumsum(gaps)[:-1]]))
    return np.concatenate(times) if times else np.zeros(0)


def requests(mix: Dict, vocab: int, seed: int, seconds: float
             ) -> Iterator[Request]:
    """The run's requests in due order: an open loop's whole schedule, or an
    endless backlog, every request due at the origin."""
    if mix["arrivals"] == "poisson":
        for rid, due in enumerate(arrival_times(mix, seed, seconds)):
            yield Request(rid, float(due), prompt(mix, vocab, seed, rid),
                          mix["gen_len"])
        return
    rid = 0
    while True:
        yield Request(rid, 0.0, prompt(mix, vocab, seed, rid), mix["gen_len"])
        rid += 1
