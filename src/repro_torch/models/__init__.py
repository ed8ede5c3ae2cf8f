"""Model of the port: configuration, layers, ragged MoE and the paged
prefill/decode entry points (``model``)."""
