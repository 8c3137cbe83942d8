"""Scoring-layout registry, counterpart of
``bayeslms_tpu/rescore/layouts/__init__.py``.

A layout is a name, a selection predicate over the scorer and a score
function ``fn(scorer, nbest, word2idx, stream_fn, enc_all)``. The port
registers ``packed-carry`` (the LSTM with carry-over) and
``packed-nocarry`` for the Transformer, which the JAX package routes there
whatever ``carry_over`` says. Every configuration the JAX package would
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
    Layout("packed-nocarry", packed.nocarry_allowed,
           packed.score_packed_nocarry),
)


def select(scorer) -> Layout:
    for layout in LAYOUTS:
        if layout.when(scorer):
            return layout
    raise NotImplementedError(
        "the LSTM with carry_over=False scores through the recurrent "
        "packed-nocarry or slotted-bucketed layout, not ported yet: "
        "ROADMAP.md queue A item 4")
