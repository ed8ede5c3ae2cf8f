"""DynaExq core of the port: expert banks and handles (``ver``), the byte
budget, slot pools, hotness, policy, the transition pipeline on CUDA
streams and the per-layer controller; parameter trees in the reference's
leaf order (``tree``)."""
