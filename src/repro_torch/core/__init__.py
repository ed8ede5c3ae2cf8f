"""DynaExq core of the port: expert banks and handles (``ver``), the byte
budget, slot pools, hotness, policy, the transition pipeline on CUDA
streams and the per-layer controller."""
