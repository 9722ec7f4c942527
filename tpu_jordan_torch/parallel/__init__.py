"""The distributed path: the paper's own layout, over ``torch.distributed``.
Counterpart of the JAX package's ``parallel/``: the 1D row-block-cyclic
layout end to end (the invert engines, the ring residual, the streamed file
scatter, the [A | B] solves and the segment entries of the checkpointed
runs), the 2D block-cyclic layout on a (pr, pc) mesh (the same engines,
solves and segment entries, the SUMMA residual, the streamed scatter), and
the pre-shard_map augmented engines on both layouts.

  * ``layout``: the cyclic index math (main.cpp:95-127) and permutations;
  * ``group``: :class:`WorkerGroup`, the backend rule and the transport
    table, ``distributed_init`` (torchrun);
  * ``launch``: ``run_workers``, p spawned ranks under a deadline (no JAX
    counterpart: the JAX package is single-controller);
  * ``world``: :class:`World`, a persistent world of ranks that runs many
    jobs (the mesh lanes' and the distributed ``JordanSolver``'s);
  * ``sharded_jordan``: the 1D augmented engine on [A | I];
  * ``generate``: each rank's strip of a generator's matrix;
  * ``scatter_stream``: each rank's strip of a matrix file, read one strip
    at a time;
  * ``sharded_inplace``: the inplace, lookahead, grouped and swap-free
    engines (``invert_blocks``), the solves (``solve_blocks``), the
    segment entries, the gathers and the corner;
  * ``permute``: the swap-free engine's row permutation;
  * ``ring_gemm``: the systolic ring GEMM and the distributed residual;
  * ``jordan2d``: each rank's 2D shard of a matrix (scattered, generated),
    the gathers, the SUMMA residual and the 2D augmented engine; ``jordan2d_inplace``: the 2D
    engines, solves, segment entries, gathers and corner (the mesh:
    ``group.MeshGroup2D``);
  * ``dist_solve``: one rank of ``driver.solve(workers=p)``, of
    ``linalg.solve_system(workers=p)`` and of a distributed measurement
    (1D and 2D).
"""

from .generate import generate_shard, sharded_generate
from .group import (TRANSPORT, MeshGroup2D, MeshSizeError, WorkerGroup,
                    backend_rule, distributed_init, mesh_group)
from .jordan2d import (augmented_blocks_2d, distributed_residual_2d,
                       invert_augmented_2d, scatter_augmented_2d,
                       scatter_matrix_2d, sharded_generate_2d)
from .jordan2d_inplace import (ENGINES_2D, compile_sharded_jordan_inplace_2d,
                               compile_sharded_jordan_solve_2d,
                               gather_inverse_inplace_2d, gather_solution_2d,
                               inverse_corner_2d, invert_blocks_2d,
                               invert_shards_2d, scatter_rhs_2d,
                               solve_blocks_2d)
from .launch import WorkerError, run_calls, run_workers
from .sharded_jordan import augmented_blocks, invert_augmented_1d
from .world import World, rank_state
from .layout import CyclicLayout, CyclicLayout2D
from .ring_gemm import (distributed_residual, distributed_residual_blocks,
                        residual_shards, ring_gemm_blocks, ring_matmul)
from .scatter_stream import stream_scatter_1d, stream_scatter_2d
from .sharded_inplace import (ENGINES_1D, compile_sharded_jordan_solve,
                              gather_inverse_inplace, gather_solution_1d,
                              inverse_corner_1d, invert_blocks,
                              invert_shards, scatter_rhs_1d, solve_blocks,
                              to_identity_padded_blocks)

__all__ = [
    "CyclicLayout", "CyclicLayout2D", "ENGINES_1D", "ENGINES_2D", "World",
    "augmented_blocks", "augmented_blocks_2d", "invert_augmented_1d",
    "invert_augmented_2d", "rank_state",
    "MeshGroup2D", "MeshSizeError", "TRANSPORT", "WorkerError",
    "WorkerGroup", "backend_rule", "compile_sharded_jordan_inplace_2d",
    "compile_sharded_jordan_solve", "compile_sharded_jordan_solve_2d",
    "distributed_init", "distributed_residual",
    "distributed_residual_2d", "distributed_residual_blocks",
    "gather_inverse_inplace", "gather_inverse_inplace_2d",
    "gather_solution_1d", "gather_solution_2d", "generate_shard",
    "inverse_corner_1d", "inverse_corner_2d", "invert_blocks",
    "invert_blocks_2d", "invert_shards", "invert_shards_2d", "mesh_group",
    "residual_shards", "ring_gemm_blocks", "ring_matmul", "run_calls",
    "run_workers", "scatter_augmented_2d", "scatter_matrix_2d",
    "scatter_rhs_1d", "scatter_rhs_2d", "sharded_generate",
    "sharded_generate_2d", "solve_blocks", "solve_blocks_2d",
    "stream_scatter_1d", "stream_scatter_2d", "to_identity_padded_blocks",
]
