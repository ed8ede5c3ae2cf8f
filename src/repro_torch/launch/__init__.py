"""Entry points of the port: the serving launcher (``launch.serve``, run as
``python -m repro_torch.launch.serve``, ``--ep-shards N`` for expert
parallelism), the training launcher (``launch.train``, ``python -m
repro_torch.launch.train``), the distribution context the MoE layer reads
(``launch.dist``), the process groups of expert-parallel serving
(``launch.mesh``: ``make_ep_mesh``, ``spawn``) and the analytic roofline
model of the expert traffic (``launch.roofline``)."""
