"""The port's kernels: CUDA C++ sources in ``csrc/``, their build
(``build``), wrappers with launch counters (``ops``) and plain PyTorch
versions (``ref``)."""
