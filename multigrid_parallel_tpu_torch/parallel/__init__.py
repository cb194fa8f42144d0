"""Distributed layer: the process-group handle, halo exchange and the
i-sharded cycles (counterpart of ``multigrid_parallel_tpu.parallel``).

The JAX package runs ``shard_map`` over a ``jax.sharding.Mesh`` with
``lax.ppermute`` halos, ``psum`` norms and a gather-to-replicated coarse
section, the analogue of the reference's OpenMP i-slab decomposition and
its ``omp single`` coarse solve (mg_3d.h:1262-1277). Here every rank is a
process of an initialised ``torch.distributed`` group and calls the same
step on its own blocks (SPMD): halos travel by
``dist.batch_isend_irecv``, norms by ``all_reduce``, the coarse section
by ``all_gather``. ``launch.launch`` starts such a group.

Ported: the Dirichlet solve, ``sharded`` (plain ops) and
``sharded_padded`` (the kernel path, ``ops.pallas_sharded``), the
electrospray mixed-BC solve, ``sharded_mixed`` (plain f64 ops) and
``sharded_mixed_padded`` (the kernel path, the sharded kernels of
``ops.pallas_mixed``), and the (i, j) decomposition of the Dirichlet
solve over an (nx, ny) grid of the ranks, ``sharded2d`` (plain ops) and
``sharded2d_padded`` (the kernel path, ``ops.pallas_sharded2d``).
"""

from multigrid_parallel_tpu_torch.parallel import (  # noqa: E402
    sharded,
    sharded2d,
    sharded2d_padded,
    sharded_mixed,
    sharded_mixed_padded,
    sharded_padded,
)
from multigrid_parallel_tpu_torch.parallel.sharded import Mesh, ShardPlan, make_mesh  # noqa: E402
from multigrid_parallel_tpu_torch.parallel.sharded2d import (  # noqa: E402
    Mesh2D,
    ShardPlan2D,
    make_mesh_2d,
)

__all__ = [
    "Mesh", "Mesh2D", "ShardPlan", "ShardPlan2D", "make_mesh", "make_mesh_2d", "sharded",
    "sharded2d", "sharded2d_padded", "sharded_mixed", "sharded_mixed_padded", "sharded_padded",
]
