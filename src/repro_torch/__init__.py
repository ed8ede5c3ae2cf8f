"""PyTorch/CUDA port of the DynaExq serving system for one NVIDIA H100.

The package mirrors the module names of the JAX reference package
(``src/repro``) so each counterpart is easy to find, but is written in
PyTorch idiom and imports neither JAX nor the reference package. Its main
path is serving through ``serving.InferenceEngine`` (the reference's
request front: sampling, prefix sharing, SLO tiers, chunked prefill,
preemption; self-speculative decoding and the watchdogs of ``fault``)
with a paged KV pool, ragged MoE dispatch and the
mixed-precision expert banks of ``core.ver``; the kernels of that path
are hand-written CUDA C++ in ``kernels/csrc`` (see ``kernels.ops``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without that request they raise (``resolve_device``).
The dry run (``launch.dryrun``) runs them on ``meta`` tensors, inside
``launch.dist.dry_run()`` only.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, the CPU only
    when asked for explicitly. Raises when CUDA is requested (or defaulted
    to) but absent — an entry point never falls back quietly. ``"meta"``
    (shapes only) inside ``launch.dist.dry_run()`` only."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "meta":
        from repro_torch.launch.dist import dry_running
        if not dry_running():
            raise ValueError("the meta device is the dry run's: run under "
                             "repro_torch.launch.dist.dry_run()")
        return dev
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
