"""Modality frontends: stand-ins, as in the reference (``models/frontend.py``).

The audio frontend (log-mel, two convolutions, GELU) and the vision
frontend (anyres tiling, ViT, projector) are not implemented in either
package; a request brings precomputed frame or patch embeddings of the
model's width, and these helpers draw seeded random ones for smoke runs
(bf16 normal × 0.02, as the reference's; the random bits differ from
JAX's).
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ArchConfig


def _stub(generator: torch.Generator, shape, device) -> torch.Tensor:
    x = torch.randn(shape, generator=generator, device=generator.device)
    return (x * 0.02).to(torch.bfloat16).to(device)


def audio_frame_embeddings(generator: torch.Generator, cfg: ArchConfig,
                           batch: int, device=None) -> torch.Tensor:
    """Whisper's frontend output: (B, encoder_seq, d_model) bf16 on
    ``device`` (default: the generator's)."""
    return _stub(generator, (batch, cfg.encoder_seq, cfg.d_model),
                 device or generator.device)


def image_patch_embeddings(generator: torch.Generator, cfg: ArchConfig,
                           batch: int, device=None) -> torch.Tensor:
    """LLaVA's frontend output: (B, num_image_tokens, d_model) bf16 on
    ``device`` (default: the generator's)."""
    return _stub(generator, (batch, cfg.num_image_tokens, cfg.d_model),
                 device or generator.device)
