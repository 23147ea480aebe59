"""dataset readers of the PyTorch/CUDA port."""
