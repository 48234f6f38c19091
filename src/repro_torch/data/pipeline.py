"""Deterministic synthetic token pipeline (numpy; the port keeps its own copy
of the reference's src/repro/data/pipeline.py, batch for batch the same).

Production posture: every (step, shard) pair maps to an independent counter
-based RNG stream, so the pipeline is (a) deterministic under restart — the
trainer can resume mid-epoch from only the step number in the checkpoint
manifest — and (b) elastic — resharding to a different data-parallel degree
re-partitions the same global stream without duplicating or dropping
samples.  Tokens follow a Zipf distribution (vocab-shaped like text) with a
a structured "copy span" pattern so the LM loss is learnable in smoke runs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticLMDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3

    def batch_at(self, step: int, shard: int = 0, n_shards: int = 1
                 ) -> Dict[str, np.ndarray]:
        """The shard's slice of global batch `step`.  Deterministic in
        (step, shard, n_shards): restarts and elastic resizes replay the
        identical global stream."""
        if self.global_batch % n_shards:
            raise ValueError(f"batch {self.global_batch} % shards {n_shards}")
        per = self.global_batch // n_shards
        rows = []
        for r in range(per):
            global_row = shard * per + r
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, global_row]))
            row = rng.zipf(self.zipf_a, size=self.seq_len + 1)
            row = np.minimum(row - 1, self.vocab_size - 1)
            # copy-span structure: second half repeats a shifted first half
            half = (self.seq_len + 1) // 2
            span = min(half // 2, 64)
            if span > 4:
                row[half:half + span] = row[:span]
            rows.append(row)
        tokens = np.stack(rows).astype(np.int32)
        return {"tokens": tokens}


def make_batch_iterator(dataset: SyntheticLMDataset, *, start_step: int = 0,
                        shard: int = 0, n_shards: int = 1
                        ) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield dataset.batch_at(step, shard, n_shards)
        step += 1
