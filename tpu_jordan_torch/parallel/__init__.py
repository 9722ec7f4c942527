"""The distributed path: the paper's own layout, over ``torch.distributed``.
Counterpart of the JAX package's ``parallel/`` (ROADMAP.md Queue A item
15a: the 1D row-block-cyclic invert engines and the ring residual; the 2D
layout is item 15c, the streamed file scatter and the distributed solves
item 15b, the pre-shard_map engines item 15d).

  * ``layout``: the cyclic index math (main.cpp:95-127) and permutations;
  * ``group``: :class:`WorkerGroup`, the backend rule and the transport
    table, ``distributed_init`` (torchrun);
  * ``launch``: ``run_workers``, p spawned ranks under a deadline (no JAX
    counterpart: the JAX package is single-controller);
  * ``generate``: each rank's strip of a generator's matrix;
  * ``sharded_inplace``: the inplace, lookahead, grouped and swap-free
    engines (``invert_blocks``), the gather and the corner;
  * ``permute``: the swap-free engine's row permutation;
  * ``ring_gemm``: the systolic ring GEMM and the distributed residual;
  * ``dist_solve``: one rank of ``driver.solve(workers=p)``.
"""

from .generate import generate_shard, sharded_generate
from .group import (TRANSPORT, MeshSizeError, WorkerGroup, backend_rule,
                    distributed_init)
from .launch import WorkerError, run_calls, run_workers
from .layout import CyclicLayout, CyclicLayout2D
from .ring_gemm import (distributed_residual, distributed_residual_blocks,
                        residual_shards, ring_gemm_blocks, ring_matmul)
from .sharded_inplace import (ENGINES_1D, gather_inverse_inplace,
                              inverse_corner_1d, invert_blocks,
                              invert_shards, to_identity_padded_blocks)

__all__ = [
    "CyclicLayout", "CyclicLayout2D", "ENGINES_1D", "MeshSizeError",
    "TRANSPORT", "WorkerError", "WorkerGroup", "backend_rule",
    "distributed_init", "distributed_residual",
    "distributed_residual_blocks", "gather_inverse_inplace",
    "generate_shard", "inverse_corner_1d", "invert_blocks", "invert_shards",
    "residual_shards", "ring_gemm_blocks", "ring_matmul", "run_calls",
    "run_workers", "sharded_generate", "to_identity_padded_blocks",
]
