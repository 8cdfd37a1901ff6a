"""Hand-written CUDA kernels of the slab path, each beside its plain
PyTorch version (sources in ``../csrc``, built by ``_build``)."""
