"""Scoring-layout registry, counterpart of
``bayeslms_tpu/rescore/layouts/__init__.py``.

A layout is a name, a selection predicate over the scorer and a score
function ``fn(scorer, nbest, word2idx, stream_fn, enc_all)``. This slice
registers ``packed-carry`` only. Every configuration the JAX package would
route elsewhere raises ``NotImplementedError`` naming the ROADMAP.md item
that ports its layout; none is rerouted.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from . import packed


class Layout(NamedTuple):
    name: str
    when: Callable  # predicate over the scorer
    fn: Callable    # fn(scorer, nbest, word2idx, stream_fn, enc_all)


LAYOUTS = (
    Layout("packed-carry", packed.carry_allowed, packed.score_carry_packed),
)


def select(scorer) -> Layout:
    for layout in LAYOUTS:
        if layout.when(scorer):
            return layout
    raise NotImplementedError(
        "carry_over=False scores through packed-nocarry or slotted-bucketed, "
        "not ported yet: ROADMAP.md queue A item 4")
