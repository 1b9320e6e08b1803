"""tpuasr_torch DeepSpeechCTC against the JAX model on converted weights (CPU).

Weights come from the JAX ``model.init`` (batch-norm running statistics
randomized so the norms do real work) and cross through
``from_jax_variables``. The JAX GRU kernels run with ``interpret=True``
(selected by the JAX package off a TPU; see test_torch_gru.py); the port's
run their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuasr.models import create_model as j_create_model
from tpuasr_torch.convert import (from_jax_variables, load_npz, save_npz,
                                  to_jax_variables)
from tpuasr_torch.models import create_model

B, T, F, C = 3, 40, 16, 16
BASE = dict(num_classes=C, rnn_hidden=32, rnn_layers=2, conv_channels=4,
            dropout=0.0)
KERNEL_F32 = dict(pallas_gru=True, fused_proj=True)
KERNEL_INT8 = dict(pallas_gru=True, bf16_gru=True, fused_proj=True,
                   int8_proj=True)
KERNEL_INT8_REC = dict(KERNEL_INT8, int8_rec=True)


# Every test file starts with empty JAX caches (tests/jax_cache_isolation.py).
pytest_plugins = ["jax_cache_isolation"]


def _inputs():
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((B, T, F)).astype(np.float32)
    lens = np.array([T, T - 9, 5], np.int32)
    return feats, lens


def jax_variables(kw, feats, lens, seed=0):
    model = j_create_model("deepspeech_ctc", **BASE, **kw)
    v = model.init(jax.random.PRNGKey(seed), jnp.asarray(feats),
                   jnp.asarray(lens), train=False)
    v = jax.tree.map(np.asarray, v)
    rng = np.random.default_rng(seed + 100)
    for stats in v["batch_stats"].values():
        stats["mean"] = (rng.standard_normal(stats["mean"].shape)
                         * 0.1).astype(np.float32)
        stats["var"] = (1.0 + rng.random(stats["var"].shape)).astype(
            np.float32)
    return model, v


# Tolerances: f32 differs only in summation order (1e-4).
# The bf16 modes round to bf16 at the same places on both sides (the stream
# after each norm, the GRU outputs, h before h@Wh) and the int8 sums are
# exact, so they agree unless an fp32 sum that differs in its last bit
# straddles a bf16 rounding boundary; one such flip moves a log-prob by
# about 1e-3 at these widths, hence 2e-3.
@pytest.mark.parametrize("kw,tol", [
    (dict(), 1e-4),
    (KERNEL_F32, 1e-4),
    (KERNEL_INT8, 2e-3),
    (KERNEL_INT8_REC, 2e-3),
], ids=["scan_f32", "fused_f32", "bf16_int8_proj", "bf16_int8_rec"])
def test_model_matches_jax(kw, tol):
    feats, lens = _inputs()
    jm, v = jax_variables(kw, feats, lens)
    lp_j, ol_j = jm.apply(v, jnp.asarray(feats), jnp.asarray(lens),
                          train=False)
    tm = create_model("deepspeech_ctc", **BASE, **kw, in_features=F)
    tm.load_state_dict(from_jax_variables(v))
    with torch.inference_mode():
        lp_t, ol_t = tm(torch.tensor(feats), torch.tensor(lens))
    np.testing.assert_array_equal(ol_t.numpy(), np.asarray(ol_j))
    assert lp_t.shape == tuple(lp_j.shape)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=0,
                               atol=tol)
    # Padded frames are exactly zero.
    assert (lp_t[2, int(ol_t[2]):] == 0).all()


def test_convert_roundtrip_and_npz(tmp_path):
    tm = create_model("deepspeech_ctc", **BASE, in_features=F,
                      generator=torch.Generator().manual_seed(3))
    tree = to_jax_variables(tm.state_dict())
    assert tree["params"]["conv1"]["kernel"].shape == (11, 41, 1, 4)
    assert tree["params"]["head"]["kernel"].shape == (64, C)
    assert tree["batch_stats"]["rnn0_bn"]["var"].shape == (16,)
    save_npz(tree, tmp_path / "w.npz", meta={"num_classes": C})
    back = load_npz(tmp_path / "w.npz")
    assert back["meta"] == {"num_classes": C}
    sd = from_jax_variables(back)
    assert sd.keys() == tm.state_dict().keys()
    for k, v in tm.state_dict().items():
        assert torch.equal(sd[k], v), k


def test_seeded_init_is_deterministic():
    kw = dict(BASE, in_features=F)
    a = create_model("deepspeech_ctc", **kw,
                     generator=torch.Generator().manual_seed(7))
    b = create_model("deepspeech_ctc", **kw,
                     generator=torch.Generator().manual_seed(7))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    wh = a.rnn0.fwd.wh.detach()
    torch.testing.assert_close(wh @ wh.T, torch.eye(32), atol=1e-5,
                               rtol=0)


# bidirectional=False and explicit_pad are ported (the streaming model);
# without the second direction fused_bidir is ignored, so bf16_gru still
# needs the kernel path.
@pytest.mark.parametrize("kw", [
    dict(bf16_conv=True),
    dict(bidirectional=False, fused_bidir=True, bf16_gru=True),
    dict(bidirectional=False, explicit_pad=True, bf16_conv=True),
    dict(pallas_gru=True, bf16_gru=True),
])
def test_unported_flags_raise(kw):
    with pytest.raises(NotImplementedError):
        create_model("deepspeech_ctc", **BASE, **kw, in_features=F)
