"""Training over a mesh of processes (``torch.distributed``)."""
