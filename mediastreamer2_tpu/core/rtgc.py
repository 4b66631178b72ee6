"""Realtime GC discipline for paced runs.

A gen-2 CPython garbage collection in this process (hundreds of MB of
numpy buffers, futures churn, jax tracing caches) can take ~100 ms on a
one-core host (seen as a ~110 ms io_pull spike in the mixed fleet): ONE
pause starves every co-resident member's 10 ms
edge and shows up as a late-tick cluster on all of them.

The reference runtime is C with no collector to pause (its ticker loop
never allocates cyclically; src/base/msticker.c:448).  The batched
analogue: paced sections run with the collector OFF and the startup heap
frozen out of scan reach, with one explicit collect at section exit.
Reference-counting still frees the per-tick numpy buffers immediately —
only CYCLE collection is deferred, so the run's floating garbage is
bounded by the few cyclic objects benches create (futures, frames of
exception state), not by tick traffic.
"""
from __future__ import annotations

import contextlib
import gc


@contextlib.contextmanager
def paused_gc():
    """Collect now, freeze survivors, disable cycle GC; restore on exit.

    Re-entrant: nesting keeps GC off until the outermost exit (tracked by
    a module counter) so a paced bench inside the fleet can't re-enable
    collection mid-run.
    """
    global _depth
    _depth += 1
    try:
        if _depth == 1:
            gc.collect()
            gc.freeze()          # startup heap never rescanned
            gc.disable()
        yield
    finally:
        _depth -= 1
        if _depth == 0:
            gc.enable()
            gc.unfreeze()
            gc.collect()


_depth = 0
