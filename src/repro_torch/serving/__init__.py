"""Serving of the port: the continuous-batching ``engine``, residency
``backends``, the paged ``kvpool`` and its ``prefix`` trie, ``requests``,
the ``sampler``, the SLO-tiered ``scheduler``, the decode ``graphs``,
the batch tier's all-lo view (``lobanks``) and self-speculative decoding
on it (``spec``)."""
