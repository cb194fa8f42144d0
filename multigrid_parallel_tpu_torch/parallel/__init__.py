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

Ported: ``sharded`` (plain ops) and ``sharded_padded`` (the kernel path,
``ops.pallas_sharded``). The (i, j) decomposition and the sharded
electrospray path are later slices.
"""
