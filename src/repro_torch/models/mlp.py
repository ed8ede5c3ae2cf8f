"""Dense feed-forward blocks (the port of the reference's
``models/mlp.py``): the SwiGLU (``init_swiglu``/``swiglu``) of the shared
expert of MoE layers that have one and of every dense FFN position, and
the GELU MLP (``init_gelu_mlp``/``gelu_mlp``) of encoder layers."""
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


def init_swiglu(normal, d_model: int, d_ff: int) -> Dict[str, torch.Tensor]:
    """The reference's leaves: (d, F), (d, F), (F, d) bf16, each scaled by
    its fan_in^-1/2. ``normal(shape, scale)``: the caller's seeded draw
    (with its leading layer axis)."""
    return {"w_gate": normal((d_model, d_ff), d_model ** -0.5),
            "w_up": normal((d_model, d_ff), d_model ** -0.5),
            "w_down": normal((d_ff, d_model), d_ff ** -0.5)}


def swiglu(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``(silu(x @ w_gate) * (x @ w_up)) @ w_down`` with the reference's
    casts: the SiLU in float32, cast back to ``x``'s dtype before the
    product with the up projection. Weights with a leading batch axis
    (one expert each) take ``x`` batched the same way."""
    g = torch.nn.functional.silu(bf16_matmul(x, p["w_gate"]).float()) \
        .to(x.dtype)
    return bf16_matmul(g * bf16_matmul(x, p["w_up"]), p["w_down"])


def init_gelu_mlp(normal, d_model: int, d_ff: int) -> Dict[str, torch.Tensor]:
    """The reference's leaves: (d, F) and (F, d) bf16, each scaled by its
    fan_in^-1/2, drawn as ``init_swiglu``'s."""
    return {"w_up": normal((d_model, d_ff), d_model ** -0.5),
            "w_down": normal((d_ff, d_model), d_ff ** -0.5)}


def gelu_mlp(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``gelu(x @ w_up) @ w_down`` with the reference's casts: the GELU in
    float32 in its tanh form (``jax.nn.gelu``'s default), cast back to
    ``x``'s dtype before the down projection."""
    h = torch.nn.functional.gelu(bf16_matmul(x, p["w_up"]).float(),
                                 approximate="tanh").to(x.dtype)
    return bf16_matmul(h, p["w_down"])
