"""Offline per-expert quantization-sensitivity scores (the port's
counterpart of the reference's ``quant/sensitivity.py``, in its ``.npz``
format).

The global allocator ranks (layer, expert) cells by ``hotness ×
sensitivity``: an expert whose weights survive int4/int2 nearly unchanged
can serve hot traffic from the lo tier, while a fragile one earns a hi slot
at lower traffic.

* **weight-space** (default): relative Frobenius quantization error
  ``‖W − dq(q(W))‖_F / ‖W‖_F`` per (layer, expert), averaged over the
  expert's projection matrices. Deterministic and data-free; equal to the
  reference's up to float32 summation order.
* **activation-aware** (``probes > 0``): the same ratio through random
  probe activations ``‖x(W − Ŵ)‖_F / ‖xW‖_F``. The probes are drawn from
  ``torch.Generator().manual_seed(seed)`` (one (probes, K) draw per
  projection, in name order); the reference draws them from JAX's PRNG,
  so the two packages' probe scores differ.

The pass runs where the experts are (on the card, the banks' dense
source), one layer at a time, so its float32 scratch stays one layer's.
Scores are consumed normalized to unit mean (``normalize``) and persist
with ``save_sensitivity``/``load_sensitivity``: one ``.npz``, a key
``pos_{position}`` per MoE position.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.quant.qtensor import dequant_arrays, quantize


def expert_sensitivity(experts: Dict[str, torch.Tensor], lo_bits: int,
                       group_size: int = 64, probes: int = 0,
                       seed: int = 0) -> np.ndarray:
    """(L, E) float32 sensitivity of one MoE stack's experts to the
    lo-tier quantizer. ``experts``: name → (L, E, K, N) dense weights."""
    gen = torch.Generator().manual_seed(seed)
    per_name = []
    for name in sorted(experts):
        stack = experts[name]
        x = None
        if probes > 0:
            x = torch.randn((probes, stack.shape[-2]), generator=gen,
                            dtype=torch.float32).to(stack.device)
        rows = []
        for l in range(stack.shape[0]):
            w = stack[l].to(torch.float32)
            q = quantize(w, bits=lo_bits, group_size=group_size)
            err = w - dequant_arrays(q.packed, q.scales, lo_bits,
                                     group_size, torch.float32)
            if x is not None:
                w = torch.einsum("pk,ekn->epn", x, w)
                err = torch.einsum("pk,ekn->epn", x, err)
            num = torch.sqrt(torch.sum(err * err, dim=(-2, -1)))
            den = torch.sqrt(torch.sum(w * w, dim=(-2, -1)))
            rows.append(num / torch.clamp(den, min=1e-12))
        per_name.append(torch.stack(rows).cpu().numpy())
    return np.mean(np.stack(per_name, 0), axis=0)


def normalize(sens: np.ndarray) -> np.ndarray:
    """Unit-mean scores: sensitivity bends the hotness ranking, it must not
    rescale the shared budget currency (all-equal scores are a no-op)."""
    s = np.asarray(sens, np.float64)
    m = s.mean()
    if not np.isfinite(m) or m <= 0:
        return np.ones_like(s)
    return s / m


def model_sensitivity(params: Dict, moe_positions, lo_bits: int,
                      group_size: int = 64, probes: int = 0,
                      seed: int = 0) -> Dict[str, np.ndarray]:
    """Sensitivity for every MoE position of a params tree: position key →
    (L, E) raw scores (normalize at the point of use)."""
    out: Dict[str, np.ndarray] = {}
    for pos in moe_positions:
        experts = params["blocks"][str(pos)]["moe"]["experts"]
        if experts is None:
            raise ValueError(
                f"position {pos}: experts already freed — run the "
                f"sensitivity pass before bank materialization")
        out[str(pos)] = expert_sensitivity(
            experts, lo_bits, group_size=group_size, probes=probes,
            seed=seed)
    return out


def save_sensitivity(path: str, sens_by_pos: Dict[str, np.ndarray]) -> None:
    np.savez(path, **{f"pos_{k}": np.asarray(v, np.float64)
                      for k, v in sens_by_pos.items()})


def load_sensitivity(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k[len("pos_"):]: z[k] for k in z.files
                if k.startswith("pos_")}
