"""What decides ``correct``: the served tokens against the plain reference,
and the block tables the decode steps read against the replicas.

Tokens.  Once the window has closed, a sample of the finished requests is
drawn from the seed.  The reference (``perfbench/reference/<name>.py``) runs
once over each request's prompt, token 0 (the first decode input, as the
program feeds it) and its served tokens but the last, and reads the logits
at every decode position.  A served token is greedy: the number compared is
the widest gap by which a served token's reference logit lies below the
reference's best at its position (``logit_gap``).  The control is the same
gap for the token that the reference in fp8 puts first.

Tables.  After each wave's last step (``table_report``): each live row's
blocks, as its home pod's device replica holds them, must name the frames
the step's page walk gave the decode (``replica_stale`` counts those that do
not), no frame may serve two live blocks of one pool or lie outside the pool
(``frame_conflicts``), and the manager's own count of replica entries that
differ from the host's table must be 0 (``replica_mismatch``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

#: an entry of the block table: the frame in the low 28 bits
FRAME_BITS = 28
ENTRIES_PER_TABLE = 512


def table_report(kv, phys: torch.Tensor, active: Sequence[int],
                 home: Sequence[int], into: Dict[str, float]) -> None:
    """Add this wave's counts to ``into``: (see the module's docstring)."""
    replicas = kv.replicas.cpu().numpy()
    frames = phys.cpu().numpy()
    logical = kv.logical_tables(list(active))
    f_local = kv.n_frames // kv.n_pools
    stale = conflicts = 0
    used: Dict[int, set] = {}
    for r, sid in enumerate(active):
        if sid < 0:
            continue
        live = logical[r] >= 0
        lb = logical[r][live]
        held = replicas[home[r], lb // ENTRIES_PER_TABLE, lb % ENTRIES_PER_TABLE]
        got = frames[r][live]
        stale += int(((held < 0) | ((held & ((1 << FRAME_BITS) - 1)) != got)).sum())
        pool = used.setdefault(kv.host.seqs[sid].pool, set())
        conflicts += int(((got < 0) | (got >= f_local)).sum())
        before = len(pool)
        pool.update(got.tolist())
        conflicts += got.size - (len(pool) - before)
    mismatch = kv.replica_mismatches(full=False)
    for name, value in (("replica_stale", stale), ("frame_conflicts", conflicts),
                        ("replica_mismatch", mismatch)):
        into[name] = into.get(name, 0) + value


def sample(served: List, k: int, seed: int, batch: int) -> List:
    """k served requests drawn from the seed, one from each of k bands of
    batch rows (so that both halves of a wave are in it), each the one
    with the most tokens served in its band, ties drawn at random."""
    rng = np.random.default_rng([seed, 1 << 21])
    picked = []
    for band in np.array_split(np.arange(batch), k):
        pool = [r for r in served if band[0] <= r.row <= band[-1]]
        if not pool:
            continue
        most = max(len(r.tokens) for r in pool)
        pool = [r for r in pool if len(r.tokens) == most]
        picked.append(pool[int(rng.integers(len(pool)))])
    return picked


def served_sequences(reqs: List, device) -> tuple:
    """Each request's tokens as the program read them (prompt, token 0,
    served tokens but the last) and the decode positions."""
    seqs, positions = [], []
    for r in reqs:
        toks = np.concatenate([r.prompt, [0], np.asarray(r.tokens[:-1])])
        seqs.append(torch.as_tensor(toks, dtype=torch.long, device=device))
        S = len(r.prompt)
        positions.append(range(S, S + len(r.tokens)))
    return seqs, positions


def served_gaps(ref_logits: List[torch.Tensor], reqs: List) -> np.ndarray:
    """Per compared position: the reference's best logit minus its logit
    of the served token."""
    out = []
    for lg, r in zip(ref_logits, reqs):
        served = torch.as_tensor(r.tokens, dtype=torch.long, device=lg.device)
        out.append((lg.amax(-1) - lg.gather(1, served[:, None])[:, 0]).cpu())
    return torch.cat(out).numpy() if out else np.zeros(0)


def control_gaps(ref_logits: List[torch.Tensor],
                 low_logits: List[torch.Tensor]) -> np.ndarray:
    """Per position: the reference's best logit minus its logit of the
    token that the lower precision puts first."""
    out = []
    for lg, low in zip(ref_logits, low_logits):
        first = low.argmax(-1)
        out.append((lg.amax(-1) - lg.gather(1, first[:, None])[:, 0]).cpu())
    return torch.cat(out).numpy() if out else np.zeros(0)
