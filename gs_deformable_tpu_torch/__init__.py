"""PyTorch + CUDA port of gs_deformable_tpu for one NVIDIA H100.

The JAX package stays the reference; this package imports torch, numpy and
the standard library, and Pillow inside the readers that open images
(``data/readers.py``), so it imports without Pillow.  Kernels in ``csrc/``
build with nvcc for ``sm_90a`` at first use (see ``_build.py``).
"""
