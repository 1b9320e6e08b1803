"""K10's plain version (``gather_rows_plain``, the CPU side of
``gather_rows``) against the JAX package's ``gather_rows`` (Pallas, run
with the package's own ``interpret=True`` off a TPU), on the same int32
tables and indices: exact, including indices past the last row (clamped).

One deliberate difference: a negative index. The JAX gather normalizes it
as Python indexing does (-1 is the last row); K10 clamps it to row 0, the
clamp of XLA's gather operation. The graph search never passes one (its
state ids are >= 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuasr.ops.pallas_gather import gather_rows as j_gather_rows
from tpuasr_torch.ops.gather import gather_rows, gather_rows_plain


# Every test file starts with empty JAX caches (tests/jax_cache_isolation.py).
pytest_plugins = ["jax_cache_isolation"]


def _packed_table(seed, S, C):
    """(S, 2C) int32 like the graph search's: next states (with -1 for a
    forbidden class, and small ids whose float bits are denormal) beside
    float32 cost bits."""
    rng = np.random.default_rng(seed)
    nxt = rng.integers(-1, S, size=(S, C)).astype(np.int32)
    cost = rng.uniform(-2, 12, size=(S, C)).astype(np.float32)
    return np.concatenate([nxt, cost.view(np.int32)], axis=1)


@pytest.mark.parametrize("S,C,shape", [(300, 64, (8, 4)), (57, 16, (23,)),
                                       (1, 8, (3, 2))])
def test_matches_jax_gather_rows(S, C, shape):
    table = _packed_table(S, S, C)
    rng = np.random.default_rng(S + 1)
    idx = rng.integers(0, S + 40, size=shape).astype(np.int32)
    idx.flat[0] = S - 1
    idx.flat[-1] = S + 1000                        # clamped to the last row
    want = np.asarray(j_gather_rows(jnp.asarray(table), jnp.asarray(idx)))
    got = gather_rows_plain(torch.tensor(table), torch.tensor(idx))
    assert got.dtype == torch.int32 and tuple(got.shape) == shape + (2 * C,)
    np.testing.assert_array_equal(got.numpy(), want)
    # The float half survives bit for bit.
    np.testing.assert_array_equal(got[..., C:].numpy().view(np.float32),
                                  want[..., C:].view(np.float32))


def test_negative_index_clamps_to_row_zero():
    table = _packed_table(0, 6, 4)
    got = gather_rows_plain(torch.tensor(table), torch.tensor([-1, -7, 2]))
    np.testing.assert_array_equal(got.numpy(), table[[0, 0, 2]])


def test_cpu_wrapper_runs_the_plain_version():
    table = torch.tensor(_packed_table(3, 40, 8))
    idx = torch.tensor([[0, 39, 41], [5, 5, 12]], dtype=torch.int64)
    before = gather_rows.launches
    assert torch.equal(gather_rows(table, idx), gather_rows_plain(table, idx))
    assert gather_rows.launches == before
