"""The benchmark of the PyTorch and CUDA port (``gs_deformable_tpu_torch``)."""
