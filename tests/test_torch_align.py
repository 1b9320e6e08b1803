"""tpuasr_torch's ``ctc_align`` and ``python -m tpuasr_torch.cli.stream``
against the JAX package's (CPU): alignments exact on a ragged batch, and
the stream CLI's output lines equal to JAX's ``stream.py`` on a written wav
and a JAX checkpoint of the streaming model (``torch_streaming_common.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from torch_streaming_common import C, MODEL, SR, UNITS, make_setup
from tpuasr.cli import stream as j_stream
from tpuasr.losses import ctc_align as j_ctc_align
from tpuasr.models import create_model as j_create_model
from tpuasr.train.checkpoints import save_checkpoint as j_save_checkpoint
from tpuasr_torch.cli import stream
from tpuasr_torch.losses import ctc_align


# Every test file starts with empty JAX caches (tests/jax_cache_isolation.py).
pytest_plugins = ["jax_cache_isolation"]


@pytest.fixture(scope="module")
def setup():
    return make_setup()


# ---- ctc_align --------------------------------------------------------------

def test_ctc_align_matches_jax():
    """A ragged batch of 3 (a row with a repeated label, which needs a blank
    between, and a row too short for its labels, infeasible): every integer
    output exact, the path scores within 1e-5 relative."""
    rng = np.random.default_rng(4)
    B, T, Cn, U = 3, 30, 7, 5
    logits = rng.standard_normal((B, T, Cn)).astype(np.float32) * 3
    logp = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(
        np.float32)
    labels = np.array([[1, 2, 3, 4, 5], [2, 2, 6, 0, 0], [3, 1, 3, 5, 0]],
                      np.int32)
    in_len = np.array([30, 12, 3], np.int32)
    lab_len = np.array([5, 3, 4], np.int32)
    want = j_ctc_align(jnp.asarray(logp), jnp.asarray(labels),
                       jnp.asarray(in_len), jnp.asarray(lab_len))
    got = ctc_align(torch.as_tensor(logp), torch.as_tensor(labels),
                    torch.as_tensor(in_len), torch.as_tensor(lab_len))
    for k in ("frame_states", "frame_labels", "token_starts", "token_ends",
              "feasible"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), rtol=1e-5)
    assert got["feasible"].tolist() == [True, True, False]


# ---- python -m tpuasr_torch.cli.stream --------------------------------------

@pytest.fixture(scope="module")
def cli_files(setup, tmp_path_factory):
    """A written wav, a JAX checkpoint of the unidirectional model (JAX's
    save_checkpoint, the meta as its Trainer writes it), one of the
    bidirectional model, one whose meta has SAME padding, and the units."""
    s = setup
    tmp = tmp_path_factory.mktemp("stream")
    wavfile.write(tmp / "a.wav", SR,
                  np.clip(s["wav"] * 16000, -32768, 32767).astype(np.int16))
    kw = {k: v for k, v in MODEL.items() if k != "num_classes"}
    meta = dict(model="deepspeech_ctc", num_classes=C, model_kwargs=kw,
                feature=dataclasses.asdict(s["jfc"]))
    j_save_checkpoint(tmp / "uni", {"step": np.int32(0), "params": s["v"][
        "params"], "batch_stats": s["v"]["batch_stats"]}, 0, meta=meta)
    bm = j_create_model("deepspeech_ctc", num_classes=C, rnn_hidden=16,
                        rnn_layers=2, conv_channels=4)
    bv = bm.init(jax.random.PRNGKey(0), jnp.zeros((1, 20, 32)),
                 jnp.array([20]), train=False)
    j_save_checkpoint(tmp / "bi", bv, 0, meta=dict(
        meta, model_kwargs=dict(rnn_hidden=16, rnn_layers=2,
                                conv_channels=4)))
    j_save_checkpoint(tmp / "same", {"step": np.int32(0), "params": s["v"][
        "params"], "batch_stats": s["v"]["batch_stats"]}, 0, meta=dict(
            meta, model_kwargs=dict(kw, explicit_pad=False)))
    (tmp / "units.txt").write_text("\n".join(UNITS))
    return tmp


@pytest.mark.parametrize("flags", [
    [], ["--timestamps"], ["--beam", "--timestamps"],
], ids=["greedy", "greedy-timestamps", "beam-timestamps"])
def test_cli_stream_matches_jax(cli_files, capsys, flags):
    """``python -m tpuasr_torch.cli.stream`` on a written wav and a JAX
    checkpoint: its output lines equal JAX's ``stream.py`` on the same
    arguments (greedy; greedy with emission times; the beam with the
    forced alignment's spans)."""
    argv = [str(cli_files / "a.wav"), "--checkpoint", str(cli_files / "uni"),
            "--units", str(cli_files / "units.txt"), "--chunk-ms", "500",
            *flags]
    assert j_stream.main(argv) == 0
    want = capsys.readouterr().out.splitlines()
    assert stream.main([*argv, "--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert got == want
    assert got[-1 if "--beam" not in flags else -2].startswith(
        "# transcript: t")
    if "--beam" in flags:
        assert got[-1].startswith("# align: t")


def test_cli_stream_refuses_a_bidirectional_checkpoint(cli_files):
    argv = [str(cli_files / "a.wav"), "--checkpoint", str(cli_files / "bi")]
    with pytest.raises(SystemExit) as j_exit:
        j_stream.main(argv)
    with pytest.raises(SystemExit) as t_exit:
        stream.main([*argv, "--device", "cpu"])
    assert str(t_exit.value) == str(j_exit.value)
    assert "unidirectional" in str(t_exit.value)


def test_cli_stream_refuses_a_same_padded_checkpoint(cli_files):
    """A unidirectional checkpoint without explicit_pad: JAX's stream.py
    takes it and streams other values than its offline model; the port
    exits before loading it."""
    argv = [str(cli_files / "a.wav"), "--checkpoint", str(cli_files / "same"),
            "--device", "cpu"]
    with pytest.raises(SystemExit, match="explicit padding"):
        stream.main(argv)
