"""Hand-written CUDA kernels of the port, one package each, with their
plain PyTorch versions. Sources live in ``repro_torch/csrc``; ``build``
compiles them with ``nvcc`` at first use."""
