"""Scoring-layout registry, counterpart of
``bayeslms_tpu/rescore/layouts/__init__.py``.

A layout is a name, a selection predicate over the scorer and a score
function ``fn(scorer, nbest, word2idx, stream_fn, enc_all)``. ``select``
walks the table in order and returns the first match: the JAX package's
five layouts with its predicates, in its order. ``xl`` (the Transformer
with ``xl_mems``) comes first; the packed layouts (``packed.py``) are
preferred wherever their gates allow and the slotted ones (``slotted.py``)
take the rest: MC scoring, and the opt-outs ``BAYESLM_PACKED_CARRY``,
``BAYESLM_PACKED_NOCARRY`` and ``BAYESLM_PACKED_TM`` set to ``0``. The
JAX package's other routes to the slotted layouts (its fused CE switched
off, cross-family interpolation) do not exist here: the port always
fuses, and its scorer refuses a cross-family pair.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from . import packed, slotted, xl


class Layout(NamedTuple):
    name: str
    when: Callable  # predicate over the scorer
    fn: Callable    # fn(scorer, nbest, word2idx, stream_fn, enc_all)


LAYOUTS = (
    # Transformer-XL memories force their own serial layout (the scorer
    # refuses xl_mems for any other configuration)
    Layout("xl", lambda s: s.is_tm and s.rcfg.xl_mems, xl.score_xl),
    # recurrent carry-over: packed time where the gates allow, else
    # utterance slots
    Layout("packed-carry",
           lambda s: not s.is_tm and s.rcfg.carry_over
           and packed.carry_allowed(s),
           packed.score_carry_packed),
    Layout("slotted-carry", lambda s: not s.is_tm and s.rcfg.carry_over,
           slotted.score_carry),
    # independent hypotheses (every Transformer; the recurrent model
    # without carry-over): bin-packed columns where the gates allow, else
    # length buckets
    Layout("packed-nocarry", packed.nocarry_allowed,
           packed.score_packed_nocarry),
    Layout("slotted-bucketed", lambda s: True, slotted.score_bucketed),
)


def select(scorer) -> Layout:
    for layout in LAYOUTS:
        if layout.when(scorer):
            return layout
    raise AssertionError("unreachable: slotted-bucketed matches all")
