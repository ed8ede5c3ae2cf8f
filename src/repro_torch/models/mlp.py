"""Dense SwiGLU feed-forward (the port of the reference's
``models/mlp.py::swiglu``): the shared expert of MoE layers that have one."""
from __future__ import annotations

from typing import Dict

import torch


def bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 ``a @ b`` (batched over leading axes) with float32 accumulation
    and one rounding to bf16, as XLA's bf16 dot and cuBLAS do it. The CPU's
    bf16 GEMM rounds partial sums, so there the product runs in float32
    and is cast once."""
    if a.is_cuda:
        return a @ b
    return (a.float() @ b.float()).to(a.dtype)


def swiglu(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``(silu(x @ w_gate) * (x @ w_up)) @ w_down`` with the reference's
    casts: the SiLU in float32, cast back to ``x``'s dtype before the
    product with the up projection. Weights with a leading batch axis
    (one expert each) take ``x`` batched the same way."""
    g = torch.nn.functional.silu(bf16_matmul(x, p["w_gate"]).float()) \
        .to(x.dtype)
    return bf16_matmul(g * bf16_matmul(x, p["w_up"]), p["w_down"])
