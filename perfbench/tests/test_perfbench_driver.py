"""The request driver against the program's own ``serve()``: with every
request due at once it forms the same waves, and gives the same tokens and
host-protocol counters."""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import serve
from repro_torch.models import init_params

from perfbench.driver import Driver
from perfbench.traffic import Request


def test_driver_matches_serve():
    cfg = get_smoke_config("nemotron_4_15b")
    seed, n, B, S, G = 3, 8, 4, 32, 6
    params = init_params(cfg, torch.Generator().manual_seed(seed))
    want = serve("nemotron_4_15b", n_requests=n, prompt_len=S, gen_len=G,
                 batch=B, n_pods=4, mode="numapte", seed=seed, verbose=False,
                 device="cpu", cfg=cfg, params=params, n_pools=4,
                 replicas=True)
    # serve()'s prompts: one draw of [batch, prompt_len] a wave
    rng = np.random.default_rng(seed)
    prompts = np.concatenate([rng.integers(0, cfg.vocab_size, (B, S))
                              for _ in range(n // B)])
    reqs = iter([Request(i, 0.0, prompts[i], G) for i in range(n)])
    max_blocks = -(-(S + G) // cfg.kv_block_tokens) + 1
    mix = {"batch": B, "prompt_len": S, "gen_len": G,
           "kv_frames": B * max_blocks * 4, "trace_decode_steps": 1}
    drv = Driver(cfg, params, mix, {"pods": 4, "pools": 4, "mode": "numapte"},
                 torch.device("cpu"))
    drv.warm_up()
    out = drv.serve(reqs, lead_in=0.0, seconds=0.2, backlog=False)
    got = np.array([r.tokens for r in out["requests"]])
    assert got.shape == (n, G)
    assert np.array_equal(got, want["token_ids"])
    c = drv.kv.host.counters
    for key in ("invalidations_sent", "invalidations_filtered",
                "coherence_bytes", "fetches", "prefetched"):
        assert getattr(c, key) == want[key], key
    assert dataclasses.asdict(c)["allocs"] == n
    assert drv.kv.footprint_pages() == want["table_pages"]
    assert drv.checks == {"replica_stale": 0, "frame_conflicts": 0,
                          "replica_mismatch": 0}
    assert len(drv.prefills) == n // B and len(drv.steps) == n // B * G
