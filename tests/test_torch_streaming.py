"""tpuasr_torch's streaming recognition against the JAX package (CPU): the
unidirectional explicit-pad model offline and in training, K5's recurrence
from a carried state (plain version), ``StreamingRecognizer`` (greedy, beam,
bigram fusion, graph) and what streaming refuses.

Setup (``torch_streaming_common.py``): JAX's streaming test model and audio
(tests/test_streaming.py:13-27), weights carried across by
``from_jax_variables``. Integers are exact (tokens, ``token_frames``);
log-probs within 1e-5 absolute of JAX. The batched recognizer is in
``test_torch_streaming_batched.py``, ``ctc_align`` and ``cli.stream`` in
``test_torch_align.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_streaming_common import (BEAM_CASES, C, LOGP_TOL, MODEL,
                                    beam_kwargs, collapse, feed, make_setup,
                                    toy_graph)
from tpuasr.decode import BeamSearchConfig as JBeamSearchConfig
from tpuasr.features import FeatureConfig as JFeatureConfig
from tpuasr.features import Featurizer as JFeaturizer
from tpuasr.models import create_model as j_create_model
from tpuasr.serve import StreamingRecognizer as JStreamingRecognizer
from tpuasr_torch.convert import from_jax_variables
from tpuasr_torch.decode import ctc_beam_search_xla, greedy_decode
from tpuasr_torch.features import FeatureConfig
from tpuasr_torch.models import create_model
from tpuasr_torch.ops.gru import gru_scan_fwd, gru_scan_plain
from tpuasr_torch.serve import (BatchedStreamingRecognizer,
                                StreamingRecognizer)


# Every test file starts with empty JAX caches (tests/jax_cache_isolation.py).
pytest_plugins = ["jax_cache_isolation"]


@pytest.fixture(scope="module")
def setup():
    return make_setup()


# ---- the offline model ------------------------------------------------------

@pytest.mark.parametrize("explicit_pad", [True, False],
                         ids=["explicit", "same"])
@pytest.mark.parametrize("T", [41, 40], ids=["odd", "even"])
def test_offline_unidirectional_matches_jax(explicit_pad, T):
    """The unidirectional model in eval against ``model.apply`` at an odd
    and an even T (where explicit and SAME padding differ), on a ragged
    batch, the norms' running statistics randomized: log-probs within
    1e-5, out_lens exact, padded frames zero."""
    kw = dict(MODEL, explicit_pad=explicit_pad)
    rng = np.random.default_rng(T)
    feats = rng.standard_normal((3, T, 32)).astype(np.float32)
    lens = np.array([T, T - 7, 4], np.int32)
    jm = j_create_model("deepspeech_ctc", **kw)
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1), feats, lens,
                                         train=False))
    for st in v["batch_stats"].values():
        st["mean"] = (rng.standard_normal(st["mean"].shape) * 0.1).astype(
            np.float32)
        st["var"] = (1.0 + rng.random(st["var"].shape)).astype(np.float32)
    lp_j, ol_j = jm.apply(v, feats, lens, train=False)
    tm = create_model("deepspeech_ctc", **kw, in_features=32)
    tm.load_state_dict(from_jax_variables(v))
    assert tm.rnn0.wx.shape == (32 // 4 * 4, 48) and tm.rnn1.wx.shape == (
        16, 48)
    with torch.no_grad():
        lp_t, ol_t = tm(torch.as_tensor(feats), torch.as_tensor(lens))
    np.testing.assert_array_equal(ol_t.numpy(), np.asarray(ol_j))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=0,
                               atol=LOGP_TOL)
    for b, n in enumerate(ol_t.tolist()):
        assert not bool(lp_t[b, n:].any())


def test_unidirectional_train_step_matches_jax():
    """Two train steps of the unidirectional explicit-pad model (the first
    update is zero at warmup_steps=1) through the port's Trainer against
    JAX's Trainer.train_step: loss and grad-norm within rtol 1e-4, and every
    parameter and batch statistic after the real SGD update within 1e-5
    (test_torch_train.py's tolerances): the gradients agree."""
    from jax.tree_util import keystr, tree_flatten_with_path

    from tpuasr.parallel import make_mesh
    from tpuasr.train import TrainConfig as JTrainConfig
    from tpuasr.train import Trainer as JTrainer
    from tpuasr_torch.train import TrainConfig, Trainer

    rng = np.random.default_rng(0)
    B, S, U = 3, 8000, 5
    wav = (rng.standard_normal((B, S)) * 0.1).astype(np.float32)
    wav_lens = np.array([S, 6000, 4500], np.int32)
    for i in range(B):
        wav[i, wav_lens[i]:] = 0.0
    batch = dict(wav=wav, wav_lens=wav_lens,
                 tokens=rng.integers(1, C, (B, U)).astype(np.int32),
                 token_lens=np.array([5, 3, 2], np.int32),
                 real=np.ones(B, np.int32))
    mk = {k: v for k, v in MODEL.items() if k != "num_classes"}
    kw = dict(model="deepspeech_ctc", model_kwargs=dict(mk, pallas_gru=True),
              num_classes=C, warmup_steps=1, ctc_impl="pallas",
              optimizer="sgd", lr=1e-3)
    jt = JTrainer(JTrainConfig(**kw), JFeatureConfig(),
                  mesh=make_mesh(devices=jax.devices()[:1]))
    js = jt.init_state(batch)
    tt = Trainer(TrainConfig(**kw), FeatureConfig(), device="cpu")
    ts = tt.init_state({"params": jax.tree.map(np.asarray, js.params),
                        "batch_stats": jax.tree.map(np.asarray,
                                                    js.batch_stats)})
    for _ in range(2):
        js, mj = jt.train_step(js, batch)
        ts, mt = tt.train_step(ts, batch)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-4)
    want = {keystr(p): np.asarray(x) for p, x in tree_flatten_with_path(
        {"params": js.params, "batch_stats": js.batch_stats})[0]}
    got = {keystr(p): np.asarray(x)
           for p, x in tree_flatten_with_path(ts.variables())[0]}
    assert set(got) == set(want) and "['params']['rnn1']['wh']" in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)


# ---- K5's recurrence from a carried state -----------------------------------

def _scan_inputs(seed=0, T=13, B=3, D=8, H=16):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(T, B, D, generator=g)
    wx = torch.randn(D, 3 * H, generator=g) / D ** 0.5
    wh = torch.randn(H, 3 * H, generator=g) / H ** 0.5
    b = torch.randn(3 * H, generator=g) * 0.1
    h0 = torch.randn(B, H, generator=g) * 0.5
    xp = (x.reshape(T * B, D) @ wx + b).reshape(T, B, 3 * H)
    return x, wx, wh, b, h0, xp


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_from_h0_chunked_equals_one_run(reverse):
    """A scan over T steps from h0 equals a scan over its first 5 steps in
    scan order then one over the rest from the first's last state, bit for
    bit (the plain version, which the wrapper runs on CPU tensors); and a
    null h0 is the zero state's scan."""
    x, wx, wh, b, h0, xp = _scan_inputs()
    T, B, _ = x.shape
    mask = torch.ones(T, B, 1)

    def run(t0, t1, h):
        return gru_scan_fwd(xp[t0:t1], wh, mask[t0:t1], reverse, h0=h)

    with torch.no_grad():
        whole = run(0, T, h0)
        if reverse:
            rest = run(5, T, h0)
            a = run(0, 5, rest[0])
            chunked = torch.cat([a, rest])
        else:
            a = run(0, 5, h0)
            chunked = torch.cat([a, run(5, T, a[-1])])
        zero = run(0, T, torch.zeros(B, 16))
        null = run(0, T, None)
    assert torch.equal(chunked, whole)
    assert torch.equal(zero, null)
    assert torch.equal(gru_scan_plain(xp, wh, mask, reverse, h0=h0), whole)


def test_scan_from_h0_matches_jax_lax_scan():
    """``gru_scan_plain`` from h0 against JAX streaming's own recurrence
    (streaming.py:203-211: lax.scan(step, h0, xp)) per batch row, within
    1e-6; a masked step keeps the state, so a row masked throughout is h0."""
    x, wx, wh, b, h0, xp = _scan_inputs(seed=1)
    T, B, H3 = xp.shape
    H = H3 // 3
    mask = torch.ones(T, B, 1)
    mask[:, 2] = 0.0
    got = gru_scan_plain(xp, wh, mask, h0=h0)
    whj = jnp.asarray(wh.numpy())

    def step(h, xp_t):
        hp = h @ whj
        r = jax.nn.sigmoid(xp_t[:H] + hp[:H])
        z = jax.nn.sigmoid(xp_t[H:2 * H] + hp[H:2 * H])
        n = jnp.tanh(xp_t[2 * H:] + r * hp[2 * H:])
        h_new = (1.0 - z) * n + z * h
        return h_new, h_new

    for bi in range(2):
        _, ys = jax.lax.scan(step, jnp.asarray(h0[bi].numpy()),
                             jnp.asarray(xp[:, bi].numpy()))
        np.testing.assert_allclose(got[:, bi].numpy(), np.asarray(ys),
                                   rtol=0, atol=1e-6)
    assert torch.equal(got[:, 2], h0[2].expand(T, H))


def test_scan_from_h0_has_no_backward():
    x, wx, wh, b, h0, xp = _scan_inputs()
    mask = torch.ones(x.shape[0], x.shape[1], 1)
    with pytest.raises(ValueError, match="no backward"):
        gru_scan_fwd(xp, wh.requires_grad_(), mask, h0=h0)
    with pytest.raises(ValueError, match="no backward"):
        gru_scan_fwd(xp, wh, mask, h0=h0.clone().requires_grad_())
    with pytest.raises(ValueError, match="h0 must be"):
        with torch.no_grad():
            gru_scan_fwd(xp, wh, mask, h0=h0[:2])


# ---- StreamingRecognizer ----------------------------------------------------

@pytest.mark.parametrize("chunk", [1777, 4000, 50])
def test_greedy_matches_jax_and_offline(setup, chunk):
    """Greedy streaming at chunks of 1777 and 4000 samples and of 50
    (shorter than a hop): the tokens and token_frames equal JAX's
    StreamingRecognizer fed the same chunks and the port's offline greedy
    decode of the whole audio."""
    s = setup
    jr = JStreamingRecognizer(s["v"], s["jfc"])
    tr = StreamingRecognizer(s["tm"], s["fc"], device="cpu")
    want = feed(jr, s["wav"], chunk)
    got = feed(tr, s["wav"], chunk)
    toks, lens = greedy_decode(s["t_logp"][None], torch.tensor([s["t_len"]]))
    offline = toks[0, :int(lens[0])].tolist()
    ref, frames = collapse(s["t_logp"].argmax(-1)[:s["t_len"]])
    assert got == tr.tokens == want == offline == ref
    assert tr.token_frames == jr.token_frames == frames
    assert tr.frame_seconds == jr.frame_seconds == pytest.approx(0.02)


def test_keep_logp_matches_offline_and_reset_reuses(setup):
    """keep_logp's history against JAX's offline log-probs within 1e-5 (and
    the port's offline model's); reset() starts the same stream again."""
    s = setup
    tr = StreamingRecognizer(s["tm"], s["fc"], keep_logp=True, device="cpu")
    first = feed(tr, s["wav"], 1777)
    hist = np.concatenate(tr.logp_history)
    assert hist.shape == (s["t_len"], C)
    np.testing.assert_allclose(hist, s["j_logp"][:len(hist)], rtol=0,
                               atol=LOGP_TOL)
    np.testing.assert_allclose(hist, s["t_logp"].numpy()[:len(hist)],
                               rtol=0, atol=LOGP_TOL)
    tr.reset()
    assert tr.tokens == [] and tr.logp_history == []
    assert feed(tr, s["wav"], 4000) == first


@pytest.mark.parametrize("case", list(BEAM_CASES))
def test_beam_matches_jax_and_one_shot(setup, case):
    """The resumable beam across chunks of 6000 (class_topk 5; with bigram
    fusion at lm_weight 0.7; under the graph): the final tokens equal JAX's
    streaming tokens and the port's one-shot scan search on its offline
    log-probs with the same tables."""
    s = setup
    jcfg, jkw, tcfg, tkw = beam_kwargs(case)
    jr = JStreamingRecognizer(s["v"], s["jfc"], decode="beam",
                              beam_cfg=jcfg, **jkw)
    tr = StreamingRecognizer(s["tm"], s["fc"], decode="beam", beam_cfg=tcfg,
                             device="cpu", **tkw)
    for rec in (jr, tr):
        for st in range(0, len(s["wav"]), 6000):
            out = rec.feed(s["wav"][st:st + 6000])
            assert out in ([], list(rec.tokens))
        rec.flush()
    ref = ctc_beam_search_xla(s["t_logp"][None], [s["t_len"]], tcfg, **tkw)
    one_shot = ref["tokens"][0, 0, :int(ref["token_lens"][0, 0])].tolist()
    assert tr.tokens == list(jr.tokens) == one_shot
    assert len(one_shot) > 0


# ---- what streaming refuses -------------------------------------------------

@pytest.mark.parametrize("bad,match", [
    (dict(cmn=True), "cmn"), (dict(cvn=True), "cmn"),
    (dict(center=True), "kaldi framing"),
    (dict(frame_style="torch"), "kaldi framing"),
    (dict(preemphasis=0.97), "preemphasis"),
    (dict(feature_type="mfcc"), "fbank"),
    (dict(feature_type="spectrogram"), "fbank"),
    (dict(splice_left=2), "splice"), (dict(splice_right=1), "splice"),
])
def test_refuses_what_it_cannot_stream(setup, bad, match):
    fc = dataclasses.replace(setup["fc"], **bad)
    for cls in (StreamingRecognizer, BatchedStreamingRecognizer):
        args = (3,) if cls is BatchedStreamingRecognizer else ()
        with pytest.raises(ValueError, match=match):
            cls(setup["tm"], fc, *args, device="cpu")


def test_refuses_bad_modes_and_models(setup):
    s = setup
    _, tt = toy_graph()
    with pytest.raises(ValueError, match="beam"):
        StreamingRecognizer(s["tm"], s["fc"], graph=tt, device="cpu")
    with pytest.raises(ValueError, match="unknown decode mode"):
        StreamingRecognizer(s["tm"], s["fc"], decode="viterbi", device="cpu")
    bidir = create_model("deepspeech_ctc", num_classes=C, rnn_hidden=16,
                         rnn_layers=2, conv_channels=4, in_features=32)
    with pytest.raises(ValueError, match="unidirectional"):
        StreamingRecognizer(bidir, s["fc"], device="cpu")
    same = create_model("deepspeech_ctc", num_classes=C, rnn_hidden=16,
                        rnn_layers=2, conv_channels=4, in_features=32,
                        bidirectional=False)
    with pytest.raises(ValueError, match="explicit_pad=True"):
        StreamingRecognizer(same, s["fc"], device="cpu")
    with pytest.raises(ValueError, match="explicit_pad=True"):
        BatchedStreamingRecognizer(same, s["fc"], 2, device="cpu")


def test_jax_streams_preemphasis_wrongly_and_the_port_refuses(setup):
    """The reference's fault: JAX's StreamingRecognizer accepts
    preemphasis=0.97 but its chunk featurizer (streaming.py:153-161) skips
    it, so its log-probs stray from its own offline model on the same
    pre-emphasized features by far more than float32 rounding (measured
    at this size: 0.453 max abs, 0.116 mean over 149 x 6); the port
    refuses the config."""
    s = setup
    jfc = dataclasses.replace(s["jfc"], preemphasis=0.97)
    wav = s["wav"]
    feats, flens = JFeaturizer(jfc)(wav[None], np.array([len(wav)], np.int32))
    lp, ol = s["jm"].apply(s["v"], feats, flens, train=False)
    offline = np.asarray(lp)[0, :int(ol[0])]
    jr = JStreamingRecognizer(s["v"], jfc, decode="beam", keep_logp=True,
                              beam_cfg=JBeamSearchConfig(beam_width=4,
                                                         class_topk=4))
    jr.feed(wav)
    jr.flush()
    hist = np.concatenate(jr.logp_history)
    gap = float(np.abs(hist - offline[:len(hist)]).max())

    with pytest.raises(ValueError, match="preemphasis"):
        StreamingRecognizer(s["tm"], dataclasses.replace(s["fc"],
                                                         preemphasis=0.97),
                            device="cpu")


def test_jax_streams_a_same_padded_model_wrongly(setup):
    """The reference's fault: JAX's stream.py (:52) checks only
    ``bidirectional``, and its chunk pipeline pads as explicit_pad does
    (the zero context frames and the frequency padding of
    tpuasr/models/deepspeech_ctc.py:63-64), so a unidirectional SAME-padded
    model streams the explicit-pad model's values, not its own offline
    model's: measured at this size, 0.925 max abs (0.370 mean) over 149 x
    6 log-probs. The port refuses such a model
    (``test_refuses_bad_modes_and_models``) and such a checkpoint
    (tests/test_torch_align.py)."""
    s = setup
    wav = s["wav"]
    feats, flens = JFeaturizer(s["jfc"])(wav[None],
                                         np.array([len(wav)], np.int32))
    jm_same = j_create_model("deepspeech_ctc",
                             **dict(MODEL, explicit_pad=False))
    lp, ol = jm_same.apply(s["v"], feats, flens, train=False)
    offline = np.asarray(lp)[0, :int(ol[0])]
    jr = JStreamingRecognizer(s["v"], s["jfc"], keep_logp=True)
    feed(jr, wav, 4000)
    hist = np.concatenate(jr.logp_history)
    np.testing.assert_allclose(hist, s["j_logp"][:len(hist)], rtol=0,
                               atol=LOGP_TOL)
    gap = float(np.abs(hist - offline).max())
    assert hist.shape == offline.shape and gap > 0.1, gap
