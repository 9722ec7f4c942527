"""The port's 1D and 2D cyclic layout math against the JAX package's
``parallel/layout.py``, exactly (integer index math: no tolerance), over a
grid of (n, m, p) that includes ragged last blocks (n % m != 0), block
counts that are not multiples of p, and p larger than the block count.
Also the split and join of the JAX package's cyclic block tensor into the
ranks' shards (``interop``)."""

import itertools

import numpy as np
import pytest

from tpu_jordan.parallel import layout as jl

from tpu_jordan_torch import interop
from tpu_jordan_torch.parallel import layout as tl

GRID = [(n, m, p) for n, m, p in itertools.product(
    (1, 7, 8, 50, 64, 97, 256), (1, 3, 8, 16, 50), (1, 2, 3, 4, 5, 8))]


@pytest.mark.parametrize("n,m,p", GRID)
def test_index_functions_match_jax(n, m, p):
    assert tl.num_block_rows(n, m) == jl.num_block_rows(n, m)
    assert tl.last_block_height(n, m) == jl.last_block_height(n, m)
    assert tl.padded_num_blocks(n, m, p) == jl.padded_num_blocks(n, m, p)
    Nr = tl.num_block_rows(n, m)
    assert tl.find_sender(Nr, p) == jl.find_sender(Nr, p)
    for k in range(p):
        assert (tl.rows_per_worker(Nr, p, k)
                == jl.rows_per_worker(Nr, p, k))
        for i in range(0, 3 * m, max(1, m // 2)):
            assert (tl.local_to_global(i, m, p, k)
                    == jl.local_to_global(i, m, p, k))
    for r in range(Nr + p):
        assert tl.global_block_owner(r, p) == jl.global_block_owner(r, p)
        assert (tl.global_to_local_block(r, p)
                == jl.global_to_local_block(r, p))


@pytest.mark.parametrize("n,m,p", GRID)
def test_cyclic_layout_matches_jax(n, m, p):
    t, j = tl.CyclicLayout.create(n, m, p), jl.CyclicLayout.create(n, m, p)
    assert (t.n, t.m, t.p, t.Nr, t.N, t.blocks_per_worker) == (
        j.n, j.m, j.p, j.Nr, j.N, j.blocks_per_worker)
    assert t.cyclic_block_order() == j.cyclic_block_order()
    for r in range(t.Nr):
        assert (t.owner(r), t.local_slot(r)) == (j.owner(r), j.local_slot(r))
    for k in range(p):
        for s in range(t.blocks_per_worker):
            assert t.global_block(k, s) == j.global_block(k, s)
    gather, scatter = tl.cyclic_gather_perm(t), tl.cyclic_scatter_perm(t)
    assert str(gather.dtype) == str(scatter.dtype) == "torch.int64"
    np.testing.assert_array_equal(gather.numpy(),
                                  np.asarray(jl.cyclic_gather_perm(j)))
    np.testing.assert_array_equal(scatter.numpy(),
                                  np.asarray(jl.cyclic_scatter_perm(j)))


@pytest.mark.parametrize("n,m,pr,pc", [
    (n, m, pr, pc) for n, m, pr, pc in itertools.product(
        (7, 50, 64, 97), (3, 8, 16), (1, 2, 3), (1, 2, 4))])
def test_cyclic_layout_2d_matches_jax(n, m, pr, pc):
    t = tl.CyclicLayout2D.create(n, m, pr, pc)
    j = jl.CyclicLayout2D.create(n, m, pr, pc)
    assert (t.Nr, t.N, t.bpr, t.bc1, t.bc2) == (j.Nr, j.N, j.bpr, j.bc1,
                                                 j.bc2)
    assert t.row_perm() == j.row_perm()
    for nb in (t.Nr, 2 * t.Nr):
        assert t.col_perm(nb) == j.col_perm(nb)


@pytest.mark.parametrize("n,m,p", [(50, 8, 3), (64, 16, 2), (97, 8, 4)])
def test_shard_split_and_join_round_trip(n, m, p):
    """Rank k's shard of the JAX block tensor is its cyclic blocks: global
    block rows k, k + p, ... in slot order."""
    lay = jl.CyclicLayout.create(n, m, p)
    rng = np.random.default_rng(n + m + p)
    blocks = rng.standard_normal((lay.Nr, m, lay.N))
    shards = interop.split_cyclic_blocks(blocks, p)
    assert len(shards) == p
    order = lay.cyclic_block_order()
    bpw = lay.blocks_per_worker
    for k, shard in enumerate(shards):
        assert shard.shape == (bpw, m, lay.N)
        assert order[k * bpw:(k + 1) * bpw] == [s * p + k
                                                for s in range(bpw)]
    np.testing.assert_array_equal(interop.join_cyclic_blocks(shards),
                                  blocks)
    with pytest.raises(ValueError):
        interop.split_cyclic_blocks(blocks[:-1], p)
