"""Hand-written CUDA kernels for the training path, each beside its plain
PyTorch version (``ref``); ``ops`` holds the public wrappers."""
