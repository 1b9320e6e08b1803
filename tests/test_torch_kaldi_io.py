"""Kaldi ark/scp archives in the port (``tpuasr_torch.utils.kaldi_io``)
against the JAX package's (``tpuasr.utils.kaldi_io``): for the same keys and
arrays both write the same bytes, and each reads the other's files back;
the round trips, the dotted prefix and the duplicate-key error of
``tests/test_kaldi_io.py``.
"""

import numpy as np
import pytest

from tpuasr.utils import kaldi_io as j_kaldi_io
from tpuasr_torch.utils import kaldi_io


def _items(rng):
    return [("utt1", rng.standard_normal((17, 13)).astype(np.float32)),
            ("utt2", rng.standard_normal((5, 40)).astype(np.float32)),
            ("utt3", rng.standard_normal((3, 7)).astype(np.float64)),
            ("ali1", rng.integers(-1, 9, size=21).astype(np.float32)),
            ("vec2", rng.standard_normal(3).astype(np.float64)),
            ("ints", np.arange(6, dtype=np.int32).reshape(2, 3)),
            ("empty", np.zeros((0, 4), np.float32))]


@pytest.mark.parametrize("prefix", ["feats", "out.v1"])
def test_bytes_equal_jax_and_each_reads_the_other(tmp_path, rng, prefix):
    items = _items(rng)
    ours = kaldi_io.write_ark_scp(tmp_path / prefix, items)
    (tmp_path / "jax").mkdir()
    theirs = j_kaldi_io.write_ark_scp(tmp_path / "jax" / prefix, items)
    assert [p.name for p in ours] == [p.name for p in theirs] == [
        f"{prefix}.ark", f"{prefix}.scp"]
    assert ours[0].read_bytes() == theirs[0].read_bytes()
    assert (ours[1].read_text().replace(str(ours[0]), "ARK")
            == theirs[1].read_text().replace(str(theirs[0]), "ARK"))
    want = {k: (v if v.dtype in (np.float32, np.float64)
                else v.astype(np.float32)) for k, v in items}
    for read in (kaldi_io.read_ark, j_kaldi_io.read_ark):
        for ark in (ours[0], theirs[0]):
            got = dict(read(ark))
            assert list(got) == [k for k, _ in items]
            for k, v in got.items():
                assert v.dtype == want[k].dtype
                np.testing.assert_array_equal(v, want[k])
    for read in (kaldi_io.read_scp, j_kaldi_io.read_scp):
        for scp in (ours[1], theirs[1]):
            for k, v in read(scp):
                np.testing.assert_array_equal(v, want[k])
    for line in ours[1].read_text().splitlines():
        key, loc = line.split(None, 1)
        np.testing.assert_array_equal(kaldi_io.read_scp_entry(loc),
                                      j_kaldi_io.read_scp_entry(loc))
        np.testing.assert_array_equal(kaldi_io.read_scp_entry(loc), want[key])


def test_duplicate_keys_raise_and_3d_is_refused(tmp_path):
    m = np.ones((1, 2), np.float32)
    with pytest.raises(ValueError, match="duplicate ark key"):
        kaldi_io.write_ark_scp(tmp_path / "dup", [("k", m), ("k", m)])
    with pytest.raises(ValueError, match="1-D/2-D"):
        kaldi_io.write_ark_scp(tmp_path / "cube",
                               [("k", np.ones((1, 2, 3), np.float32))])


def test_reading_a_text_entry_raises(tmp_path):
    (tmp_path / "t.ark").write_bytes(b"utt1 [ 1 2 3 ]\n")
    with pytest.raises(ValueError, match="not a Kaldi binary entry"):
        dict(kaldi_io.read_ark(tmp_path / "t.ark"))
