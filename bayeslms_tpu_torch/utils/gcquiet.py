"""Defer cyclic garbage collection while a scoring pass runs (counterpart
of ``bayeslms_tpu/utils/gcquiet.py``).

A gen-2 collection over a large Python heap can take longer than a warm
pass, and a pass's garbage (numpy buffers, tuples, lists) is acyclic and
freed by reference counting anyway. ``quiet_gc()`` disables the cyclic
collector inside the block and restores its previous state when the
outermost block exits; it forces no collection. The depth counter assumes
one host thread drives the passes.
"""

import gc
from contextlib import contextmanager

_depth = 0
_reenable = False


@contextmanager
def quiet_gc():
    global _depth, _reenable
    if _depth == 0:
        _reenable = gc.isenabled()
        if _reenable:
            gc.disable()
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1
        if _depth == 0 and _reenable:
            gc.enable()
