"""Entry points of the port: the serving launcher (``launch.serve``, run as
``python -m repro_torch.launch.serve``, ``--ep-shards N`` for expert
parallelism), the training launcher (``launch.train``, ``python -m
repro_torch.launch.train``), the distribution context the MoE layer reads
(``launch.dist``), the process groups of expert-parallel serving
(``launch.mesh``: ``make_ep_mesh``, ``spawn``, the production grids),
the sharding planner (``launch.sharding``), the dry run (``launch.
dryrun``, run as ``python -m repro_torch.launch.dryrun``, over
``launch.shapes``) and the roofline (``launch.roofline``: the analytic
model of the expert traffic and the dry run's terms)."""
