"""A run with its timed path broken underneath must come out not correct,
once for each fault a served cell can have; a sound run comes out correct.
The harness runs as on the chip but for its look for a card, on the CPU at
the smoke sizes."""
import pytest
import torch

from repro_torch.launch import specs
from repro_torch.models import greedy_sample

from perfbench.tests import smoke


def _state_unchanged(monkeypatch):
    """A decode step that hands back the state it was given."""
    orig = specs.decode_on_grid

    def step(cfg, params, state, tokens, phys, grid, *, sp=False):
        logits, _ = orig(cfg, params, state, tokens, phys, grid, sp=sp)
        return logits, state
    monkeypatch.setattr(specs, "decode_on_grid", step)
    monkeypatch.setattr("repro_torch.models.attention.write_token_plain",
                        lambda k, v, *a, **kw: (k, v))


def _half_batch(monkeypatch):
    """Half of the rows decoded, the others given the mean of their logits."""
    orig = specs.decode_on_grid

    def step(cfg, params, state, tokens, phys, grid, *, sp=False):
        logits, new = orig(cfg, params, state, tokens, phys, grid, sp=sp)
        h = logits.shape[0] // 2
        logits = torch.cat([logits[:h], logits[:h].mean(0, keepdim=True)
                            .expand(logits.shape[0] - h, -1)])
        return logits, new
    monkeypatch.setattr(specs, "decode_on_grid", step)


def _no_exchange(monkeypatch):
    """The coherence prologue's exchange between pods left out."""
    monkeypatch.setattr(specs, "_coherence_prologue",
                        lambda mode, pods, entries, sharers, *a: (entries, sharers))


def _token_altered(monkeypatch):
    """Each sampled token changed where it is produced (the next id), so
    that whichever rows the sample draws read it."""
    def sampler(params, grid):
        def sample(logits):
            return (greedy_sample(logits) + 1) % logits.shape[-1]
        return sample
    monkeypatch.setattr(specs, "grid_sampler", sampler)


FAULTS = {"state_unchanged": (_state_unchanged, "logit_gap"),
          "half_batch": (_half_batch, "logit_gap"),
          "no_exchange": (_no_exchange, "replica_stale"),
          "token_altered": (_token_altered, "logit_gap")}


@pytest.mark.parametrize("workload", list(smoke.CELLS))
def test_sound_run_is_correct(workload):
    r = smoke.run(workload)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    assert {"tok_per_s", "itl_p95_ms", "setup_s"} <= set(r["metrics"])


@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    plant, caught_by = FAULTS[fault]
    plant(monkeypatch)
    r = smoke.run("relu2.backlog")
    assert not r["correct"]
    c = r["checks"][caught_by]
    assert c["value"] > c["limit"], r["checks"]
