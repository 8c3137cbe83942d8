"""Command-line interface of the port, counterpart of
``bayeslms_tpu/cli/main.py``: the same subcommands, flags and defaults.

  bayeslm-torch train    --data DIR --model LSTM --uncertainty Bayesian \\
                         --L_bayes_pos 3 --compute-dtype bfloat16 ... --save m.ckpt
  bayeslm-torch score    --nbest-list F --vocabulary words.txt --model-path m.ckpt ...
  bayeslm-torch rescore  --lattices F --words words.txt --model-path m.ckpt \\
                         --arpa lm.arpa --ref ref.txt --workdir WD
  bayeslm-torch snr      --model-path m.ckpt [--L_bayes_pos 3]
  bayeslm-torch search   --data DIR --model LSTM --search-mode bayes ...

Also ``python -m bayeslms_tpu_torch.cli.main``. ``--platform cuda`` (the
default) runs on the card and raises without one; ``--platform cpu`` runs
the kernels' plain versions on the CPU. On the card ``score`` and
``rescore`` take ``--compute-dtype float32`` (the default, as in the JAX
package) or ``bfloat16``; ``train`` and the recurrent models' MC scoring
(``--mc-samples``) take bfloat16 only there, and at float32 raise before
any device work, naming ROADMAP.md B.5's float32 training slices. ``score``
and ``rescore`` read any checkpoint ``core/checkpoint.py`` ``load_params``
reads (the port's own, a JAX ``.ckpt``, a reference ``model.pt``).

``train --resume`` continues from ``<save>.resume`` (written after each
epoch); ``--profile DIR`` writes a Chrome trace of the first trained epoch
(``train``), of the scoring (``score``) or of the pipeline (``rescore``)
into DIR. ``search`` runs the DARTS search in float32 (no kernel runs
there) and prints the softmaxed arch weights and the derived choice.

``train --dp-shards D --tp-shards T`` trains on D x T ranks and ``score`` /
``rescore --dp-shards D`` scores on D: the command starts its ranks on
this host (``parallel/multihost.py`` ``spawn``), one a card under NCCL
(``--platform cuda``, which raises before any rank starts where the ranks
outnumber the visible cards: NCCL takes one rank a card) or gloo ranks on
the CPU (``--platform cpu``). ``train --multihost`` instead joins the group
a launcher started (``torchrun``: ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``), one process a card, with
dp = the ranks / T unless ``--dp-shards`` says. Rank 0 alone prints and
writes files. A tp mesh that the port's tp step does not take (an untied
decoder, the Transformer's Bayesian EMB, a batch that does not divide)
raises ``NotImplementedError`` naming ROADMAP.md item A13b before any
rank starts. ``score`` and ``rescore``
take the scorer's options: ``--interpolation_flag`` with ``--inter_path``
(the second model), ``--mc-samples``, ``--backward`` (``--model_var
back``), ``--splice-len`` with ``--context-file``; the scorer refuses the
combinations it does not score (``rescore/scorer.py``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

from ..core.config import ModelConfig, RescoreConfig, TrainConfig


def _add_model_args(p: argparse.ArgumentParser):
    p.add_argument("--model", default="LSTM",
                   choices=["LSTM", "GRU", "RNN_TANH", "RNN_RELU", "Transformer"])
    p.add_argument("--emsize", type=int, default=1024)
    p.add_argument("--nhid", type=int, default=1024)
    p.add_argument("--nlayers", type=int, default=2)
    p.add_argument("--nhead", type=int, default=8)
    p.add_argument("--dropout", type=float, default=0.2)
    p.add_argument("--tied", action="store_true", default=True)
    p.add_argument("--not-tied", dest="tied", action="store_false")
    p.add_argument("--uncertainty", default="none",
                   choices=["none", "Bayesian", "Gaussian", "Variational"])
    p.add_argument("--T_bayes_pos", default="none",
                   choices=["none", "FFN", "MHA", "EMB"])
    p.add_argument("--L_bayes_pos", type=int, default=0)
    p.add_argument("--T_gauss_pos", type=int, default=3)
    p.add_argument("--L_gauss_pos", default="00")
    p.add_argument("--T_v_pos", type=int, default=0)
    p.add_argument("--L_v_pos", default="00")
    p.add_argument("--gp-sample", action="store_true")
    p.add_argument("--compute-dtype", default="float32")


def _model_cfg(args, vocab_size: int) -> ModelConfig:
    return ModelConfig(
        model=args.model, vocab_size=vocab_size, emsize=args.emsize,
        nhid=args.nhid, nlayers=args.nlayers, nhead=args.nhead,
        dropout=args.dropout, tied=args.tied, uncertainty=args.uncertainty,
        t_bayes_pos=args.T_bayes_pos, l_bayes_pos=args.L_bayes_pos,
        t_gauss_pos=args.T_gauss_pos, l_gauss_pos=args.L_gauss_pos,
        t_v_pos=args.T_v_pos, l_v_pos=args.L_v_pos, gp_sample=args.gp_sample,
        compute_dtype=args.compute_dtype)


def _ranks(args) -> int:
    """The ranks the command runs on: dp x tp (1 for one device)."""
    return max(getattr(args, "dp_shards", 1), 1) * max(
        getattr(args, "tp_shards", 1), 1)


def _refuse_mesh(args) -> None:
    """What the mesh's steps do not take, before any rank starts
    (``parallel/train_parallel.py`` ``check``; the vocabulary's division is
    checked by the trainer, which reads it)."""
    import torch

    if args.fn is cmd_train and _ranks(args) > 1:
        from ..parallel.train_parallel import check

        cfg = _model_cfg(args, 0)
        tcfg = TrainConfig(batch_size=args.batch_size)
        check(cfg, tcfg, max(args.dp_shards, 1), max(args.tp_shards, 1))
    n = torch.cuda.device_count()
    if args.platform == "cuda" and not getattr(args, "multihost", False) \
            and _ranks(args) > max(n, 1):
        raise ValueError(
            f"bayeslm-torch: {_ranks(args)} ranks under NCCL need as many "
            f"cards, {n} visible (NCCL takes one rank a card); pass fewer "
            "--dp-shards/--tp-shards, or --platform cpu")


def _profiled(args):
    """``trace(--profile)`` around the region (on rank 0 alone), or
    nothing."""
    from ..parallel.multihost import is_primary

    if not getattr(args, "profile", None) or not is_primary():
        return contextlib.nullcontext()
    from ..utils.profiling import trace

    return trace(args.profile)


def _check_device(args, kernels: bool = True) -> None:
    """No quiet CPU run without --platform cpu, and, where the card's
    kernels run (``kernels``), no operand dtype that a kernel of the
    command's path refuses: bfloat16 everywhere; float32 for ``score`` and
    ``rescore`` (rows 1-4 and 12-17 take it), but not for ``train`` (rows
    5-11 and 18-21, ROADMAP.md B.5a-B.5d) nor the recurrent models' MC
    scoring (row 5, B.5b)."""
    import torch

    if args.platform != "cuda":
        return
    if not torch.cuda.is_available():
        raise RuntimeError(
            "bayeslm-torch: no CUDA device; pass --platform cpu to run on "
            "the CPU with the kernels' plain versions")
    dtype = args.compute_dtype
    if not kernels or dtype == "bfloat16":
        return
    if dtype != "float32":
        raise ValueError(
            f"bayeslm-torch: --compute-dtype {dtype} on the card: its "
            "kernels take bfloat16 or float32 operands")
    if args.fn is cmd_train:
        raise ValueError(
            "bayeslm-torch train: --compute-dtype float32 on the card: the "
            "training kernels (rows 5-11, 18-21) take bf16 operands only "
            "until ROADMAP.md B.5a-B.5d (B.5's float32 training slices); "
            "pass --compute-dtype bfloat16, or --platform cpu")
    if getattr(args, "mc_samples", 0) and args.model != "Transformer":
        raise ValueError(
            f"bayeslm-torch {args.cmd}: --mc-samples of a recurrent model at "
            "--compute-dtype float32 on the card: its draws run kernel row "
            "5, which takes bf16 operands only until ROADMAP.md B.5b (B.5's "
            "float32 training slices); pass --compute-dtype bfloat16, or "
            "--platform cpu")


def cmd_train(args, mesh=None) -> int:
    from ..data.corpus import Corpus
    from ..parallel.multihost import is_primary
    from ..train.loop import Trainer

    corpus = Corpus(args.data)
    cfg = _model_cfg(args, len(corpus.vocab))
    tcfg = TrainConfig(
        lr=args.lr, batch_size=args.batch_size,
        eval_batch_size=args.eval_batch_size, epochs=args.epochs,
        seq_len=args.seq_len, clip=args.clip, seed=args.seed,
        log_interval=args.log_interval, data_fraction=args.data_fraction,
        prior=args.prior, prior_path=args.prior_path, prior_kl=args.prior_kl,
        save=args.save, rng_impl=args.rng_impl, dp_shards=args.dp_shards,
        profile_dir=args.profile, resume=args.resume)
    trainer = Trainer(cfg, tcfg, device=args.platform, mesh=mesh)
    _, out = trainer.fit(corpus)
    if is_primary():
        print(json.dumps({"test_loss": out["test_loss"]}))
    return 0


def _read_context(path, nbest):
    """The context map of a previous-decode file (dev scorer
    ``…copy.py``:101-120): per-utterance "utt text..." lines, every first
    field an N-best key, or one global line for every utterance. Returns
    (map or None, error message or None)."""
    with open(path, "r", encoding="utf-8") as f:
        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    per_utt = {}
    for ln in lines:
        head, _, rest = ln.partition(" ")
        per_utt[head] = rest
    unknown = [k for k in per_utt if k not in nbest]
    if not lines:
        return None, None
    if not unknown:
        return {k: per_utt.get(k, "") for k in nbest}, None
    if len(lines) == 1 and len(per_utt) == len(unknown) == 1:
        return {k: lines[0] for k in nbest}, None
    return None, (f"context file: {len(unknown)} first fields are not "
                  f"n-best utterance ids (e.g. {unknown[:3]}); fix the ids "
                  "or use a single global-context line")


def _inter_model(args, vocab_size: int):
    """The second model of ``--interpolation_flag``: (ModelConfig, params)
    of ``--inter_path``. The checkpoint's ``model_config`` (the port's meta,
    the JAX package's sidecar) takes precedence, so that a baseline of
    another geometry loads as trained; without one, the main model's flags
    give it, as in the reference. Its compute dtype is its own (the
    checkpoint's, as in the JAX package), the run's ``--compute-dtype``
    only where the checkpoint names none."""
    import dataclasses

    from ..core.checkpoint import load_params

    if not args.inter_path:
        raise SystemExit("--interpolation_flag requires --inter_path")
    cfg2 = _model_cfg(args, vocab_size)
    params2, meta2 = load_params(args.inter_path, cfg2, with_meta=True)
    mc = (meta2 or {}).get("model_config")
    if isinstance(mc, dict):
        known = {f.name for f in dataclasses.fields(ModelConfig)}
        mc = {k: v for k, v in mc.items() if k in known}
        if mc.get("vocab_size", 0) and mc["vocab_size"] != vocab_size:
            raise SystemExit(
                f"--inter_path model was trained with vocab_size="
                f"{mc['vocab_size']}, but the vocabulary here has "
                f"{vocab_size} entries")
        mc["vocab_size"] = vocab_size
        cfg2 = ModelConfig(**mc)
    return cfg2, params2


def _scorer(args, cfg, rcfg, vocab_size: int, mesh=None):
    """The run's ``BatchScorer``: the main model of ``--model-path`` and,
    with ``--interpolation_flag``, the second of ``--inter_path``; on
    ``mesh``'s ranks where given."""
    from ..core.checkpoint import load_params
    from ..rescore.scorer import BatchScorer

    cfg2 = params2 = None
    if args.interpolation_flag:
        cfg2, params2 = _inter_model(args, vocab_size)
    return BatchScorer(cfg, load_params(args.model_path, cfg), rcfg, cfg2,
                       params2, device=args.platform, mesh=mesh)


def cmd_score(args, mesh=None) -> int:
    """Score an N-best list with a trained model (the reference's
    compute_sentence_scores_* entry point)."""
    from ..data.vocab import Vocab
    from ..parallel.multihost import is_primary
    from ..rescore.nbest import load_nbest, write_scores

    vocab = Vocab.from_file(args.vocabulary)
    cfg = _model_cfg(args, len(vocab))
    rcfg = RescoreConfig(
        carry_over=not args.no_carry_over, inter_flag=args.interpolation_flag,
        inter_alpha=args.inter_alpha, max_hyp_len=args.max_hyp_len,
        mc_samples=args.mc_samples,
        backward=args.backward or args.model_var == "back",
        splice_len=args.splice_len, xl_mems=args.model_var == "XL")
    scorer = _scorer(args, cfg, rcfg, len(vocab), mesh)
    nbest = load_nbest(args.nbest_list)
    context_map = None
    if args.context_file:
        context_map, err = _read_context(args.context_file, nbest)
        if err:
            print(err, file=sys.stderr)
            return 1
    with _profiled(args):
        scored = scorer.score_nbest(nbest, vocab.word2idx,
                                    context_map=context_map)
    if not is_primary():
        return 0
    write_scores(scored, args.outfile)
    print(f"oov tokens: {scorer.oov_stats['total']}")
    print(f"wrote {args.outfile}")
    return 0


def cmd_rescore(args, mesh=None) -> int:
    """The lattice rescoring pipeline (the reference's
    lmrescore_nbest_*.sh). On a mesh every rank runs the pipeline, its
    scoring sharded; the ranks other than 0 work in a directory of their
    own, which they remove, and print nothing."""
    import shutil
    import tempfile

    from ..data.vocab import Vocab
    from ..parallel.multihost import is_primary
    from ..rescore.pipeline import run_pipeline

    vocab = Vocab.from_file(args.words)
    cfg = _model_cfg(args, len(vocab))
    rcfg = RescoreConfig(
        nbest=args.N, acwt=args.acwt, nn_weight=args.nn_weight,
        carry_over=not args.no_carry_over, min_lmwt=args.min_lmwt,
        max_lmwt=args.max_lmwt, inter_flag=args.interpolation_flag,
        inter_alpha=args.inter_alpha, mc_samples=args.mc_samples,
        backward=args.backward or args.model_var == "back",
        splice_len=args.splice_len, xl_mems=args.model_var == "XL",
        max_hyp_len=args.max_hyp_len)
    scorer = _scorer(args, cfg, rcfg, len(vocab), mesh)
    primary = is_primary()
    workdir = args.workdir if primary else tempfile.mkdtemp(
        prefix="bayeslm_rescore_")
    try:
        with _profiled(args):
            res = run_pipeline(
                args.lattices, args.words, scorer, vocab.word2idx, workdir,
                rcfg, arpa_lm=args.arpa, ref_text=args.ref, glm=args.glm,
                asclite_clean=args.asclite_clean,
                sanity_test=args.sanity_test)
    finally:
        if not primary:
            shutil.rmtree(workdir, ignore_errors=True)
    if not primary:
        return 0
    print(json.dumps({
        "n_utts": res.n_utts, "n_hyps": res.n_hyps,
        "oov_tokens": res.oov_tokens,
        "wer_by_lmwt": res.wer_by_lmwt, "best_lmwt": res.best_lmwt,
        "best_wer": res.best_wer,
    }))
    return 0


def cmd_snr(args) -> int:
    from ..analysis.snr import snr_from_checkpoint

    cfg = None
    if args.L_bayes_pos:
        cfg = ModelConfig(vocab_size=1, nhid=args.nhid,
                          l_bayes_pos=args.L_bayes_pos)
    print(json.dumps(snr_from_checkpoint(args.model_path, cfg), indent=2))
    return 0


def cmd_search(args) -> int:
    """The DARTS search (the JAX ``bayeslm search``): prints the softmaxed
    arch weights and the derived choice as JSON."""
    from ..data.corpus import Corpus
    from ..nas.search import SearchRunner

    corpus = Corpus(args.data)
    cfg = _model_cfg(args, len(corpus.vocab))
    tcfg = TrainConfig(lr=args.lr, batch_size=args.batch_size,
                       epochs=args.epochs, seq_len=args.seq_len,
                       clip=args.clip, seed=args.seed)
    runner = SearchRunner(cfg, tcfg, mode=args.search_mode,
                          unrolled=args.unrolled, arch_lr=args.arch_lr,
                          device=args.platform)
    res = runner.run(corpus)
    print(json.dumps({"arch_softmax": res.arch_softmax.tolist(),
                      "derived_choice": res.derived_choice.tolist()}))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bayeslm-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--platform", default="cuda", choices=["cpu", "cuda"],
                   help="where the model runs: the card (default; raises "
                        "without one) or the CPU with the kernels' plain "
                        "versions")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train a language model")
    _add_model_args(t)
    t.add_argument("--data", required=True)
    t.add_argument("--lr", type=float, default=0.1)
    t.add_argument("--batch-size", type=int, default=32)
    t.add_argument("--eval-batch-size", type=int, default=20)
    t.add_argument("--epochs", type=int, default=32)
    t.add_argument("--seq_len", type=int, default=100)
    t.add_argument("--clip", type=float, default=1.0)
    t.add_argument("--seed", type=int, default=1111)
    t.add_argument("--log-interval", type=int, default=200)
    t.add_argument("--data-fraction", type=float, default=1.0,
                   help="reference --mark base-0.Xset ablations")
    t.add_argument("--prior", action="store_true")
    t.add_argument("--prior_path", default=None)
    t.add_argument("--prior_kl", action="store_true",
                   help="regularize posterior means toward the prior ckpt "
                        "(reference kl_divergence(prior) branch)")
    t.add_argument("--rng-impl", default="rbg",
                   choices=["rbg", "threefry2x32"],
                   help="the JAX package's PRNG; kept for one command line "
                        "in both packages, the port draws from a "
                        "torch.Generator")
    t.add_argument("--dp-shards", type=int, default=1,
                   help="data-parallel ranks (one a card, or gloo ranks "
                        "with --platform cpu)")
    t.add_argument("--tp-shards", type=int, default=1,
                   help="tensor-parallel ranks (the vocabulary split over "
                        "them)")
    t.add_argument("--save", default="model.ckpt")
    t.add_argument("--resume", action="store_true",
                   help="continue from <save>.resume, written after each "
                        "epoch")
    t.add_argument("--multihost", action="store_true",
                   help="join the group a launcher (torchrun) started: "
                        "RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, "
                        "LOCAL_RANK")
    t.add_argument("--profile", default=None, metavar="DIR",
                   help="write a Chrome trace of the first trained epoch "
                        "into DIR")
    t.set_defaults(fn=cmd_train)

    s = sub.add_parser("score", help="score an n-best list")
    _add_model_args(s)
    s.add_argument("--nbest-list", required=True)
    s.add_argument("--vocabulary", required=True)
    s.add_argument("--model-path", required=True)
    s.add_argument("--outfile", required=True)
    s.add_argument("--interpolation_flag", type=int, default=0)
    s.add_argument("--inter_path", default=None)
    s.add_argument("--inter_alpha", type=float, default=0.8)
    s.add_argument("--no-carry-over", action="store_true")
    s.add_argument("--max-hyp-len", type=int, default=128)
    s.add_argument("--mc-samples", type=int, default=0,
                   help="MC-average inference over K posterior draws")
    s.add_argument("--backward", action="store_true",
                   help="backward-LM scoring (reverse word order)")
    s.add_argument("--splice-len", type=int, default=0,
                   help="context-splice length (dev scorer --seg_wise)")
    s.add_argument("--model_var", default="none",
                   choices=["none", "back", "XL"],
                   help="dev-scorer variants: back = backward LM, XL = "
                        "Transformer-XL cross-utterance memory")
    s.add_argument("--dp-shards", type=int, default=1,
                   help="score on this many ranks, each its block of the "
                        "chains or columns")
    s.add_argument("--profile", default=None, metavar="DIR",
                   help="write a Chrome trace into DIR")
    s.add_argument("--context-file", default=None,
                   help="previous-decode context text: per-utterance "
                        "'utt text…' lines or one global line "
                        "(dev scorer seg_wise file, copy.py:101-120)")
    s.set_defaults(fn=cmd_score)

    r = sub.add_parser("rescore", help="full lattice rescoring pipeline")
    _add_model_args(r)
    r.add_argument("--lattices", required=True)
    r.add_argument("--words", required=True)
    r.add_argument("--model-path", required=True)
    r.add_argument("--workdir", required=True)
    r.add_argument("--arpa", default=None)
    r.add_argument("--interpolation_flag", type=int, default=0,
                   help="1 = logit-level, 2 = score-level interpolation "
                        "with a second model")
    r.add_argument("--inter_path", default=None)
    r.add_argument("--inter_alpha", type=float, default=0.8)
    r.add_argument("--mc-samples", type=int, default=0)
    r.add_argument("--backward", action="store_true")
    r.add_argument("--splice-len", type=int, default=0)
    r.add_argument("--model_var", default="none",
                   choices=["none", "back", "XL"])
    r.add_argument("--max-hyp-len", type=int, default=128)
    r.add_argument("--profile", default=None, metavar="DIR",
                   help="write a Chrome trace into DIR")
    r.add_argument("--ref", default=None)
    r.add_argument("--N", type=int, default=20)
    r.add_argument("--acwt", type=float, default=0.1)
    r.add_argument("--nn-weight", type=float, default=1.0)
    r.add_argument("--no-carry-over", action="store_true")
    r.add_argument("--min-lmwt", type=int, default=7)
    r.add_argument("--max-lmwt", type=int, default=15)
    r.add_argument("--glm", default=None,
                   help="SCTK GLM filter rules applied to refs+hyps "
                        "(hubscr -g, score_asclite.sh:36)")
    r.add_argument("--asclite-clean", action="store_true",
                   help="drop hesitations/[noise]/<unk> from hyps "
                        "(score_asclite.sh:87-93)")
    r.add_argument("--dp-shards", type=int, default=1,
                   help="score on this many ranks, each its block of the "
                        "chains or columns")
    r.add_argument("--sanity-test", action="store_true",
                   help="reference --test true branch: rebuild lattices "
                        "without changing scores and verify the round trip "
                        "(lmrescore :176-184)")
    r.set_defaults(fn=cmd_rescore)

    n = sub.add_parser("snr", help="posterior SNR analysis (variance.py)")
    n.add_argument("--model-path", required=True)
    n.add_argument("--L_bayes_pos", type=int, default=0)
    n.add_argument("--nhid", type=int, default=1024)
    n.set_defaults(fn=cmd_snr)

    se = sub.add_parser("search", help="DARTS architecture search")
    _add_model_args(se)
    se.add_argument("--data", required=True)
    se.add_argument("--search-mode", default="bayes",
                    choices=["bayes", "gauss"])
    se.add_argument("--unrolled", action="store_true")
    se.add_argument("--arch-lr", type=float, default=3e-4)
    se.add_argument("--lr", type=float, default=1.0)
    se.add_argument("--batch-size", type=int, default=16)
    se.add_argument("--epochs", type=int, default=3)
    se.add_argument("--seq_len", type=int, default=32)
    se.add_argument("--clip", type=float, default=1.0)
    se.add_argument("--seed", type=int, default=1111)
    se.set_defaults(fn=cmd_search)
    return p


def _mesh(args):
    """This rank's mesh: dp x tp of the joined group (under --multihost
    dp = the ranks / tp unless --dp-shards says)."""
    from ..parallel.mesh import make_mesh

    tp = max(getattr(args, "tp_shards", 1), 1)
    dp = args.dp_shards if args.dp_shards > 1 else None
    return make_mesh(dp=dp, tp=tp, device=None)


def _rank(argv) -> int:
    """One rank of a command that ``main`` spawned."""
    args = build_parser().parse_args(argv)
    return args.fn(args, _mesh(args))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.fn in (cmd_train, cmd_score, cmd_rescore):
        _check_device(args)
        _refuse_mesh(args)
    elif args.fn is cmd_search:
        _check_device(args, kernels=False)
    if getattr(args, "multihost", False):
        from ..parallel.multihost import initialize_multihost

        if not initialize_multihost("nccl" if args.platform == "cuda"
                                    else "gloo"):
            print("--multihost: no launcher's group (WORLD_SIZE and "
                  "MASTER_ADDR unset)", file=sys.stderr)
            return 1
        return args.fn(args, _mesh(args))
    if _ranks(args) > 1:
        from ..parallel.multihost import spawn

        return spawn("bayeslms_tpu_torch.cli.main:_rank", _ranks(args),
                     argv, backend="nccl" if args.platform == "cuda"
                     else "gloo", timeout=None)[0]
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
