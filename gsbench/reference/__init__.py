"""The plain reference: what one frame and one training step of a cell compute,
written from the published equations in plain PyTorch.  It imports nothing of
the program, and works out for itself everything the program derives from
the benchmark's inputs."""
