"""Serving of the port: the continuous-batching ``engine``, residency
``backends``, the paged ``kvpool`` and ``requests``."""
