"""The benchmark of the PyTorch and CUDA port (``rald_torch``): see README.md."""
