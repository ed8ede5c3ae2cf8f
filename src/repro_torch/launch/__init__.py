"""Entry points of the port: the serving launcher (``launch.serve``, run as
``python -m repro_torch.launch.serve``) and the analytic roofline model of
the expert traffic (``launch.roofline``)."""
