"""Device-time measurement helpers shared by bench.py and scripts/.

The core rule: to time an op without host-dispatch overhead, iterate it
inside ONE jitted ``fori_loop`` with the op's OUTPUT carried directly.  A
carry like ``acc + 0.0 * op(acc)`` is NOT safe — XLA algebraically folds
the multiply and deletes the op entirely (scripts/bench_scaling.py once
shipped that bug).  ``loop_fn`` below carries the output, so the op
cannot be eliminated; ``tests/test_utils.py`` pins this semantics.
"""

from __future__ import annotations

import time
from typing import Callable

import jax

__all__ = ["loop_fn", "time_looped"]


def loop_fn(op: Callable, iters: int) -> Callable:
    """Return ``x -> op(op(...op(x)))`` (``iters`` times) via ``fori_loop``.

    ``op`` must be shape-preserving.  The output is the loop carry, so XLA
    must execute every iteration — no algebraic folding is possible.
    """
    def f(x):
        return jax.lax.fori_loop(0, iters, lambda i, acc: op(acc), x)
    return f


def time_looped(op: Callable, x0, iters: int = 30, repeats: int = 3) -> float:
    """Best per-iteration wall time of ``op`` iterated on device."""
    jf = jax.jit(loop_fn(op, iters))
    jax.block_until_ready(jf(x0))    # compile
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(jf(x0))
        best = min(best, (time.perf_counter() - t0) / iters)
    return best
