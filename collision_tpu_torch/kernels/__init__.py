"""Hand-written CUDA kernels of the port's paths, each beside its plain
PyTorch version (sources in ``../csrc``, built by ``_build``)."""
