"""The benchmark's own code: spec loading, data and traffic generation, the
plain reference, the comparison that decides `correct`, the trace reduction
and the two loops (closed-loop batches, open-loop served requests).

Nothing here imports jax, `oswald_tpu` or, outside `harness.py` and
`system.py`, anything of `oswald_tpu_torch`: the reference, the generator
and the metric arithmetic are the yardstick the port is held to.
"""
