"""The port's benchmark: cells of ``BENCHMARK.json`` served through
``repro_torch``'s paged-KV numaPTE path, with their metrics and the
comparison against a plain reference that decides ``correct``.

Run one cell with ``python3 perfbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout.  Nothing here
imports JAX or the JAX package ``repro`` (``imports.py`` checks it).
"""
