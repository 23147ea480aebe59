"""frontend of the PyTorch/CUDA port."""
