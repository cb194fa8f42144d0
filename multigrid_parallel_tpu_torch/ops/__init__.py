"""Stencil ops (torch), the coarse direct solve, and the hand-written
CUDA kernels with their plain versions (``pallas3d``, ``pallas_split``,
``pallas_splitcolor``, ``pallas_mixed``, ``pallas_mixed_fold``,
``pallas_mixed_split``, ``pallas_sharded``, ``pallas_sharded2d``)."""
