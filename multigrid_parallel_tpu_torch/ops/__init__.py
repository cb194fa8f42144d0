"""Stencil ops (torch), the coarse direct solve, and the hand-written
CUDA kernels with their plain versions (``pallas3d``)."""
