"""Shared CLI plumbing: the flags the CLIs share, the feature config and
the model from a checkpoint (JAX's msgpack format, the port's or JAX's) or
an ``.npz`` export, units, LM and WFST loading,
fusion tables, the beam-search dispatch with its loud fallback, and the
decoding graph for ``--graph-decode``.

Counterpart of ``tpuasr/cli/common.py``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from tpuasr_torch.data.manifest import load_wav
from tpuasr_torch.features import FeatureConfig, num_frames
from tpuasr_torch.models import MODEL_REGISTRY

__all__ = ["add_decode_flags", "add_lm_flags", "add_model_flags",
           "build_decode_graph",
           "feature_config", "fusion_tables", "load_fst", "load_lm",
           "load_model", "load_units", "load_wav", "load_weights",
           "lm_symbols", "make_word_decoder", "out_frames", "run_beam_search",
           "tokens_to_text"]


def add_model_flags(p: argparse.ArgumentParser, serving: bool = True) -> None:
    """The model name, vocabulary, feature and device flags (and, for the
    serving CLIs, ``--int8``)."""
    p.add_argument("model", choices=sorted(MODEL_REGISTRY))
    p.add_argument("--units", default=None,
                   help="units file, one token per line (line 0 = <blank>)")
    p.add_argument("--words", default=None,
                   help="words.txt symbol table (enables word output)")
    p.add_argument("--lexicon", default=None,
                   help="lexicon file 'WORD unit unit ...'; with --words, "
                        "decoded units are segmented into words")
    p.add_argument("--sample-rate", type=int, default=8000)
    p.add_argument("--n-mels", type=int, default=64)
    p.add_argument("--feature-type", default="fbank",
                   choices=["fbank", "mfcc", "spectrogram"])
    p.add_argument("--no-cmvn", action="store_true")
    if serving:
        p.add_argument("--int8", action="store_true",
                       help="int8 input projections in the GRU kernel")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; an error without a CUDA device) "
                        "or cpu")


def add_decode_flags(p: argparse.ArgumentParser) -> None:
    """The beam, LM, WFST and graph-decoding flags."""
    p.add_argument("--beam", action="store_true",
                   help="CTC prefix beam search instead of greedy")
    p.add_argument("--beam-width", type=int, default=16)
    p.add_argument("--class-topk", type=int, default=8,
                   help="classes per step of the scan search (--beam-impl "
                        "xla); the kernel search takes all classes")
    p.add_argument("--beam-impl", default="auto",
                   choices=["auto", "xla", "pallas"],
                   help="auto/pallas: the all-class beam kernel; xla: the "
                        "top-P scan search")
    add_lm_flags(p)


def add_lm_flags(p: argparse.ArgumentParser) -> None:
    """The LM, WFST and graph-decoding flags (JAX's ``add_lm_flags``, less
    the host first pass's)."""
    g = p.add_argument_group("language model and WFST")
    g.add_argument("--lm", default=None,
                   help="ARPA n-gram LM over the unit symbols (or, with "
                        "--graph-decode and a lexicon, over words)")
    g.add_argument("--lm-weight", type=float, default=1.0,
                   help="LM weight (shallow fusion or rescoring)")
    g.add_argument("--lm-fusion", action="store_true",
                   help="apply the LM inside the beam search (shallow "
                        "fusion); without it the n-best is rescored")
    g.add_argument("--lm-fusion-order", type=int, default=2, choices=[2, 3],
                   help="fusion context: 2 = bigram table, 3 = trigram "
                        "table (grows as C^3)")
    g.add_argument("--fst", default=None,
                   help="OpenFst WFST (binary or text), ilabels = unit ids: "
                        "n-best rescoring with --beam, the graph with "
                        "--graph-decode")
    g.add_argument("--fst-weight", type=float, default=1.0,
                   help="weight on the FST log-prob (minus tropical cost)")
    g.add_argument("--fst-isyms", default=None,
                   help="input symbol table for string-labeled FST text")
    g.add_argument("--fst-osyms", default=None,
                   help="output symbol table (words.txt) for FST outputs")
    gg = p.add_argument_group("graph-constrained decoding")
    gg.add_argument("--graph-decode", action="store_true",
                    help="decode under a decoding graph compiled to dense "
                         "tables (--fst, or L from --lexicon/--words/--units "
                         "composed with a word-level --lm); words by replay "
                         "through the graph. Replaces --beam")
    gg.add_argument("--graph-weight", type=float, default=1.0,
                    help="weight on graph costs against acoustics")
    gg.add_argument("--graph-topk", type=int, default=8,
                    help="classes per step, chosen per beam among the "
                         "classes the graph allows")
    gg.add_argument("--graph-prune", type=float, default=10.0,
                    help="pruned-determinization beam in cost units "
                         "(<= 0: exact determinization)")
    gg.add_argument("--graph-quantum", type=float, default=0.1,
                    help="residual grid of pruned determinization")
    gg.add_argument("--graph-max-states", type=int, default=400_000,
                    help="abort graph compilation past this many states")


def feature_config(args) -> FeatureConfig:
    no_cmvn = getattr(args, "no_cmvn", False)
    return FeatureConfig(sample_rate=args.sample_rate, n_mels=args.n_mels,
                         feature_type=args.feature_type,
                         cmn=not no_cmvn, cvn=not no_cmvn)


def load_weights(path) -> tuple[dict, dict]:
    """(Flax variable tree, meta) from a checkpoint that training wrote
    (``ckpt_*.msgpack``, or a directory: its newest; the port's or JAX's,
    read by ``train.checkpoints.load_for_inference``) or from a
    ``convert.save_npz`` export."""
    from pathlib import Path

    from tpuasr_torch.convert import load_npz
    from tpuasr_torch.train.checkpoints import load_for_inference

    if Path(path).is_dir() or str(path).endswith(".msgpack"):
        try:
            return load_for_inference(path)
        except FileNotFoundError as e:
            raise SystemExit(f"checkpoint not found: {e}") from e
    tree = load_npz(path)
    return tree, tree.pop("meta", {})


def load_model(path, args, units: list[str]):
    """(model, FeatureConfig, num_classes) from ``load_weights(path)``; the
    metadata (model, num_classes, model_kwargs, feature) wins over the
    flags, as in JAX. ``--int8`` asks a DeepSpeech model for its int8 GRU
    kernel and exits for a model without a GRU."""
    from tpuasr_torch.convert import from_jax_variables
    from tpuasr_torch.models import create_model

    tree, meta = load_weights(path)
    num_classes = meta.get("num_classes") or len(units)
    if not num_classes:
        raise SystemExit("weights carry no num_classes; pass --units")
    feat_cfg = (FeatureConfig(**meta["feature"]) if meta.get("feature")
                else feature_config(args))
    model_kwargs = dict(meta.get("model_kwargs", {}))
    name = meta.get("model", args.model)
    if args.int8:
        cls = MODEL_REGISTRY.get(name)
        if cls is not None and not cls.supports_int8:
            raise SystemExit(f"--int8 quantizes the GRU input projections; "
                             f"{name} has no GRU (serve it without --int8)")
        model_kwargs.update(pallas_gru=True, fused_proj=True, int8_proj=True)
    model = create_model(name, num_classes=num_classes,
                         in_features=feat_cfg.feat_dim, **model_kwargs)
    model.load_state_dict(from_jax_variables(tree))
    return model, feat_cfg, num_classes


def out_frames(feat_cfg: FeatureConfig, n_samples: int, model) -> int:
    """The model's output frames for a padded batch of ``n_samples``: the
    feature frames over its time stride (2 for every model here)."""
    T = num_frames(feat_cfg, n_samples)
    return max(1, -(-T // getattr(model, "time_stride", 2)))


def load_units(path: str | None) -> list[str]:
    return Path(path).read_text().splitlines() if path else []


def tokens_to_text(tokens, units: list[str]) -> str:
    if not units:
        return " ".join(str(int(t)) for t in tokens)
    return " ".join(units[int(t)] if 0 <= int(t) < len(units) else "<unk>"
                    for t in tokens)


def lm_symbols(units: list[str], num_classes: int) -> list[str]:
    return units if units else [str(i) for i in range(num_classes)]


def load_lm(args):
    """NGramLM from --lm, or None."""
    if not getattr(args, "lm", None):
        return None
    from tpuasr_torch.lm import NGramLM
    return NGramLM.load_arpa(args.lm)


def fusion_tables(lm, syms: list[str], order: int) -> dict:
    """Beam-search kwargs for shallow fusion at `order` (2 or 3)."""
    if order == 3:
        return dict(lm_trigram=lm.fusion_tensor3(syms),
                    lm_eos=lm.eos_matrix(syms))
    return dict(lm_bigram=lm.fusion_matrix(syms), lm_eos=lm.eos_vector(syms))


def run_beam_search(impl: str, logp, lens, cfg, n_best: int, **kwargs):
    """Beam search at the requested impl. Every fusion order runs in every
    impl; the only fallback is the kernel search's trigram size gate, and
    it is loud (a line on stderr)."""
    from tpuasr_torch.decode import get_beam_search
    try:
        return get_beam_search(impl)(logp, lens, cfg, n_best=n_best, **kwargs)
    except ValueError as e:
        if "XLA ctc_beam_search" not in str(e):
            raise
        print(f"# beam kernel rejected the problem ({e}); falling back to "
              "the scan search (xla)", file=sys.stderr)
        return get_beam_search("xla")(logp, lens, cfg, n_best=n_best,
                                      **kwargs)


def load_fst(args):
    """(WFST, output SymbolTable | None) from --fst flags, or (None, None)."""
    if not getattr(args, "fst", None):
        return None, None
    from tpuasr_torch.decode import WFST, SymbolTable
    isyms = SymbolTable.load(args.fst_isyms) if args.fst_isyms else None
    osyms = SymbolTable.load(args.fst_osyms) if args.fst_osyms else None
    fst = WFST.load(args.fst, isyms=isyms, osyms=osyms)
    return fst, osyms if osyms is not None else fst.osyms


def make_word_decoder(args, units: list[str]):
    """(LexiconDecoder, words SymbolTable) from --lexicon/--words, or
    (None, None) when word output is not asked for."""
    if not args.lexicon or not args.words:
        return None, None
    if not units:
        raise SystemExit("--lexicon requires --units (unit symbol table)")
    from tpuasr_torch.decode import Lexicon, LexiconDecoder, SymbolTable
    words = SymbolTable.load(args.words)
    lex = Lexicon.load(args.lexicon, words, SymbolTable.from_list(units))
    return LexiconDecoder(lex, word_score=1.0), words


def build_decode_graph(args, num_classes: int, units: list[str]):
    """The --graph-decode tables: (GraphTables, original WFST for word
    replay, word-name fn, olabel -> word-id offset).

    Two sources: ``--fst``, a prebuilt graph over unit ilabels (word names
    through --fst-osyms); or L from --lexicon/--words/--units (olabels =
    words.txt id + 1), composed with a WORD-level ARPA --lm into LG when
    one is given.
    """
    from tpuasr_torch.decode import (Lexicon, SymbolTable,
                                     compile_graph_tables, compose,
                                     lexicon_to_fst, ngram_to_fst)
    if getattr(args, "fst", None):
        fst, osyms = load_fst(args)
        name_fn = osyms.sym if osyms is not None else str
        offset = 0
    else:
        if not (args.lexicon and args.words and units):
            raise SystemExit(
                "--graph-decode needs a graph: pass --fst, or build one "
                "with --lexicon + --words + --units (+ a word-level --lm "
                "for a grammar-bearing LG)")
        words = SymbolTable.load(args.words)
        lex = Lexicon.load(args.lexicon, words, SymbolTable.from_list(units))
        # olabels = word id + 1: stable across multiple prons of a word and
        # aligned with ngram_to_fst's sym2label space.
        fst = lexicon_to_fst([(wid, pron) for wid, pron in lex.prons],
                             olabels=[wid + 1 for wid, _ in lex.prons])
        lm = load_lm(args)
        if lm is not None:
            fst = compose(fst, ngram_to_fst(
                lm, {words.sym(wid): wid + 1 for wid, _ in lex.prons}))
        name_fn = words.sym
        offset = -1
    prune = args.graph_prune if args.graph_prune > 0 else None
    try:
        tabs = compile_graph_tables(fst, num_classes,
                                    max_states=args.graph_max_states,
                                    prune=prune, quantum=args.graph_quantum)
    except ValueError as e:
        raise SystemExit(
            f"graph compilation failed: {e}\n"
            "Weighted determinization can blow up on non-twin graphs "
            "(L*G with homophones). Try --graph-prune 10 (on by default), "
            "a coarser --graph-quantum or a larger --graph-max-states."
        ) from e
    return tabs, fst, name_fn, offset
