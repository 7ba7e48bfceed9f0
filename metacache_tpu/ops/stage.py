"""Named device stages of the query step.

Each stage traces under a ``jax.named_scope`` of its name, so a profiler
trace can attribute device time to it (tools/stage_times.py). Stages
nest (the bucket probe runs inside the gather-and-decode stage, the LCA
inside the candidate stage); time goes to the innermost one.
"""
import functools

import jax

STAGES = ("sketch", "bucket_probe", "gather_decode", "candidates", "lca")


def stage(name: str):
    """Decorator: trace the function under the named scope `name`."""
    assert name in STAGES, name

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with jax.named_scope(name):
                return fn(*args, **kwargs)
        return wrapped
    return deco
