"""End-to-end N-best rescoring pipeline, counterpart of
``bayeslms_tpu/rescore/pipeline.py``: the same stages, the same files in
``workdir``.

1. lattice -> N-best archives (``lattice_to_nbest``; ``words.int``,
   ``lmwt.withlm``, ``acwt``, ``ali``)
2. old n-gram LM score per hypothesis (``arpa_score``; ``lmwt.lmonly``),
   and ``nolm = withlm - lmonly``
3. ids -> words (``int2sym``; ``words.txt``)
4. neural LM scores (``scorer.score_nbest``, one carry-over chain;
   ``nnlm.scores``)
5. interpolation ``lm = nolm + w nn + (1 - w) ngram`` (``lmwt.rescored``)
6. rescored lattices (``nbest_to_lattice``; ``rescored_lats.txt``)
7. WER sweep over the LM weights (``wer``; ``hyp.lmwt<k>.txt``): a
   hypothesis costs ``lm + acoustic / LMWT``, the cheapest one of each
   utterance is picked

``sanity_test`` is the reference's ``--test true`` branch: lattices rebuilt
from the N-best archives without changing any score, and every (lm,
acoustic) cost checked to round-trip.

The C++ tools build from ``tools/src`` at first use into
``bayeslms_tpu_torch/_build/`` (``utils/host_build.py``).
"""

from __future__ import annotations

import os
import re
import subprocess
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..core.config import RescoreConfig
from ..utils import host_build
from .nbest import load_nbest, write_scores


def _run_tool(name: str, *args, **kw):
    """Run the built tool ``name`` once; a failure raises."""
    return subprocess.run([host_build.path(name), *args], check=True, **kw)


def _read_scores(path: str) -> Dict[str, float]:
    out = {}
    with open(path) as f:
        for line in f:
            k, v = line.split()
            out[k] = float(v)
    return out


@dataclass
class PipelineResult:
    n_utts: int = 0
    n_hyps: int = 0
    oov_tokens: int = 0
    wer_by_lmwt: Dict[int, float] = field(default_factory=dict)
    best_lmwt: Optional[int] = None
    best_wer: Optional[float] = None
    best_hyps_path: Optional[str] = None
    rescored_lattices: Optional[str] = None


def _sanity_test(res, words_int, lmwt_withlm, acwt, workdir, rcfg):
    lats_out = os.path.join(workdir, "test_lats.txt")
    _run_tool("nbest_to_lattice", words_int, lmwt_withlm, acwt, lats_out)
    res.rescored_lattices = lats_out
    chk = os.path.join(workdir, "roundtrip")
    os.makedirs(chk, exist_ok=True)
    w2, g2, a2, ali2 = (os.path.join(chk, n) for n in ("w", "g", "a", "ali"))
    _run_tool("lattice_to_nbest", f"--n={rcfg.nbest}",
              f"--acoustic-scale={rcfg.acwt}", lats_out, w2, g2, a2, ali2)

    def by_words(words_path, g_path, a_path):
        # one word sequence may come from several paths with other costs:
        # every (lm, acoustic) pair of an (utterance, words), sorted
        gsc, asc = _read_scores(g_path), _read_scores(a_path)
        out: Dict[tuple, list] = {}
        n = 0
        with open(words_path) as f:
            for line in f:
                parts = line.split()
                k = parts[0]
                out.setdefault((k[: k.rfind("-")], tuple(parts[1:])),
                               []).append((gsc[k], asc[k]))
                n += 1
        for v in out.values():
            v.sort()
        return out, n

    before, n_before = by_words(words_int, lmwt_withlm, acwt)
    after, _ = by_words(w2, g2, a2)

    def close(va, vb):
        return len(va) == len(vb) and all(
            abs(a[0] - b[0]) <= 1e-3 and abs(a[1] - b[1]) <= 1e-3
            for a, b in zip(va, vb))

    bad = [k for k, v in before.items()
           if k not in after or not close(after[k], v)]
    if bad:
        raise RuntimeError(
            f"sanity test: {len(bad)} hypotheses changed scores in the "
            f"lattice round trip (first: {bad[:3]})")
    res.n_utts = len({u for u, _ in before})
    res.n_hyps = n_before
    return res


def run_pipeline(
    lattices: str,
    words_txt: str,
    scorer,
    word2idx: Dict[str, int],
    workdir: str,
    rcfg: RescoreConfig,
    arpa_lm: Optional[str] = None,
    ref_text: Optional[str] = None,
    glm: Optional[str] = None,
    asclite_clean: bool = False,
    sanity_test: bool = False,
) -> PipelineResult:
    os.makedirs(workdir, exist_ok=True)
    res = PipelineResult()
    host_build.build(host_build.TOOLS)  # all g++ processes at once

    # -- stage 1: lattice -> N-best archives
    words_int = os.path.join(workdir, "words.int")
    lmwt_withlm = os.path.join(workdir, "lmwt.withlm")
    acwt = os.path.join(workdir, "acwt")
    ali = os.path.join(workdir, "ali")
    _run_tool("lattice_to_nbest", f"--n={rcfg.nbest}",
              f"--acoustic-scale={rcfg.acwt}", lattices, words_int,
              lmwt_withlm, acwt, ali)
    if sanity_test:
        return _sanity_test(res, words_int, lmwt_withlm, acwt,
                            workdir, rcfg)

    # -- stage 3 (first: stages 2 and 4 read it): ids -> words
    words_text = os.path.join(workdir, "words.txt")
    _run_tool("int2sym", words_txt, words_int, words_text)

    # -- stage 2: old-LM scores
    lm_withlm = _read_scores(lmwt_withlm)
    if arpa_lm:
        lmonly_path = os.path.join(workdir, "lmwt.lmonly")
        _run_tool("arpa_score", arpa_lm, words_text, lmonly_path)
        lm_only = _read_scores(lmonly_path)
    else:
        lm_only = {k: 0.0 for k in lm_withlm}
    lm_nolm = {k: lm_withlm[k] - lm_only.get(k, 0.0) for k in lm_withlm}

    # -- stage 4: neural LM scores
    nbest = load_nbest(words_text)
    res.n_utts = len(nbest)
    res.n_hyps = sum(len(h) for h in nbest.values())
    scored = scorer.score_nbest(nbest, word2idx)
    res.oov_tokens = getattr(scorer, "oov_stats", {"total": 0})["total"]
    nn_path = os.path.join(workdir, "nnlm.scores")
    write_scores(scored, nn_path)
    nn_scores = _read_scores(nn_path)

    # -- stage 5: interpolation (the reference's awk)
    w = rcfg.nn_weight
    lm_final = {
        k: lm_nolm[k] + w * nn_scores.get(k, 0.0)
        + (1.0 - w) * lm_only.get(k, 0.0)
        for k in lm_withlm}
    lmwt_final = os.path.join(workdir, "lmwt.rescored")
    with open(lmwt_final, "w") as f:
        for k, v in lm_final.items():
            f.write(f"{k} {v}\n")

    # -- stage 6: rescored lattices
    lats_out = os.path.join(workdir, "rescored_lats.txt")
    _run_tool("nbest_to_lattice", words_int, lmwt_final, acwt, lats_out)
    res.rescored_lattices = lats_out

    # -- stage 7: WER sweep (needs references)
    if ref_text:
        ac_scores = _read_scores(acwt)
        hyp_texts: Dict[str, List[str]] = {}
        with open(words_text) as f:
            for line in f:
                parts = line.split()
                hyp_texts[parts[0]] = parts[1:]
        best = (None, None)
        for lmwt in range(rcfg.min_lmwt, rcfg.max_lmwt + 1):
            pick: Dict[str, str] = {}
            cost: Dict[str, float] = {}
            for k in lm_final:
                utt = k[: k.rfind("-")]
                total = lm_final[k] + ac_scores.get(k, 0.0) / lmwt
                if utt not in cost or total < cost[utt]:
                    cost[utt] = total
                    pick[utt] = k
            hyp_path = os.path.join(workdir, f"hyp.lmwt{lmwt}.txt")
            with open(hyp_path, "w") as f:
                for utt, k in pick.items():
                    f.write(utt + " " + " ".join(hyp_texts[k]) + "\n")
            opts = [*([f"--glm={glm}"] if glm else []),
                    *(["--asclite-clean"] if asclite_clean else [])]
            out = _run_tool("wer", *opts, ref_text, hyp_path,
                            capture_output=True, text=True).stdout
            wer = float(re.search(r"%WER (\d+\.\d+)", out).group(1))
            res.wer_by_lmwt[lmwt] = wer
            if best[1] is None or wer < best[1]:
                best = (lmwt, wer)
                res.best_hyps_path = hyp_path
        res.best_lmwt, res.best_wer = best
    return res
