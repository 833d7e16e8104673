"""SharedTree on PyTorch: the batched changeset rebase (BASELINE
config 4) and its hand-written CUDA kernel."""
