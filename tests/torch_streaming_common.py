"""Shared setup of the streaming tests (tests/test_torch_streaming*.py,
tests/test_torch_align.py): the unidirectional explicit-pad DeepSpeechCTC
at JAX's streaming test size (tests/test_streaming.py: 32 mels, 6 classes,
2 layers of 16 units, 4 conv channels, 3 s at 8 kHz), its weights from the
Flax ``model.init`` carried across by ``from_jax_variables``, the audio
made by numpy from a seed, and the decoding tables both packages take."""

import jax
import numpy as np
import torch

from tpuasr.decode import BeamSearchConfig as JBeamSearchConfig
from tpuasr.decode import compile_graph_tables as j_compile_graph_tables
from tpuasr.decode import compose as j_compose
from tpuasr.decode import lexicon_to_fst as j_lexicon_to_fst
from tpuasr.decode import ngram_to_fst as j_ngram_to_fst
from tpuasr.features import FeatureConfig as JFeatureConfig
from tpuasr.features import Featurizer as JFeaturizer
from tpuasr.lm import train_ngram as j_train_ngram
from tpuasr.models import create_model as j_create_model
from tpuasr_torch.convert import from_jax_variables
from tpuasr_torch.decode import BeamSearchConfig, GraphTables
from tpuasr_torch.features import FeatureConfig
from tpuasr_torch.models import create_model

C = 6
MODEL = dict(num_classes=C, bidirectional=False, explicit_pad=True,
             rnn_hidden=16, rnn_layers=2, conv_channels=4, dropout=0.0)
FEAT = dict(n_mels=32, cmn=False, cvn=False)
SR = 8000
UNITS = ["<blk>"] + [f"t{i}" for i in range(1, C)]
LOGP_TOL = 1e-5


def tone(n, freq, amp, seed):
    rng = np.random.default_rng(seed)
    return np.asarray(amp * np.sin(2 * np.pi * freq * np.arange(n) / SR)
                      + 0.1 * rng.standard_normal(n), np.float32)


def make_setup():
    """JAX's streaming test setup (tests/test_streaming.py:13-27) and the
    port's model on the same weights."""
    jfc = JFeatureConfig(**FEAT)
    jm = j_create_model("deepspeech_ctc", **MODEL)
    wav = tone(24000, 700, 1.0, 0)
    feats, flens = JFeaturizer(jfc)(wav[None],
                                    np.array([len(wav)], np.int32))
    v = jm.init(jax.random.PRNGKey(0), feats, flens, train=False)
    v = jax.tree.map(np.asarray, v)
    lp, ol = jm.apply(v, feats, flens, train=False)
    tm = create_model("deepspeech_ctc", **MODEL, in_features=32)
    tm.load_state_dict(from_jax_variables(v))
    with torch.no_grad():
        tlp, tol = tm(torch.as_tensor(np.array(feats)),
                      torch.as_tensor(np.array(flens)))
    return dict(jfc=jfc, jm=jm, v=v, wav=wav, j_logp=np.asarray(lp)[0],
                fc=FeatureConfig(**FEAT), tm=tm, t_logp=tlp[0],
                t_len=int(tol[0]))



def collapse(ids, blank=0):
    out, frames, prev = [], [], blank
    for t, i in enumerate(ids):
        i = int(i)
        if i != blank and i != prev:
            out.append(i)
            frames.append(t)
        prev = i
    return out, frames


def feed(rec, wav, chunk):
    got = []
    for s in range(0, len(wav), chunk):
        got.extend(rec.feed(wav[s:s + chunk]))
    got.extend(rec.flush())
    return got


def toy_graph():
    """JAX's streaming test graph (tests/test_streaming.py:122-134): a small
    LG over classes 1..5; the port takes the same tables."""
    prons = [("a", (1, 2)), ("b", (3,)), ("c", (4, 5)), ("d", (2, 1))]
    lm = j_train_ngram([["a", "b"], ["b", "c", "a"], ["d", "a"],
                        ["c", "d"]], order=2)
    lg = j_compose(j_lexicon_to_fst(prons),
                   j_ngram_to_fst(lm, {w: i + 1
                                       for i, (w, _) in enumerate(prons)}))
    jt = j_compile_graph_tables(lg, C)
    return jt, GraphTables(np.asarray(jt.next_state), np.asarray(jt.cost),
                           np.asarray(jt.final), start=jt.start)


def bigram(sents):
    lm = j_train_ngram(sents, order=2)
    syms = UNITS
    return dict(lm_bigram=lm.fusion_matrix(syms, blank=0),
                lm_eos=lm.eos_vector(syms))


# The beam cases: JAX's streaming tests' configurations (test_streaming.py:
# 77-160): class_topk 5, bigram fusion at lm_weight 0.7, the graph.
BEAM_CASES = {
    "topk5": (dict(beam_width=8, class_topk=5), None, False),
    "bigram": (dict(beam_width=8, class_topk=5, lm_weight=0.7),
               [["t1", "t2"], ["t3", "t1", "t4"]] * 4, False),
    "graph": (dict(beam_width=8, class_topk=5, graph_weight=0.8), None,
              True),
}


def beam_kwargs(case):
    cfg, sents, graph = BEAM_CASES[case]
    jkw, tkw = {}, {}
    if sents:
        jkw = tkw = bigram(sents)
    if graph:
        jt, tt = toy_graph()
        jkw, tkw = dict(graph=jt), dict(graph=tt)
    return (JBeamSearchConfig(**cfg), jkw, BeamSearchConfig(**cfg), tkw)

