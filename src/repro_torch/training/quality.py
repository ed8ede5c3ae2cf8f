"""Quality at budget (the paper's Table 4): the expert banks the quality
evaluation compares, built as the reference's
``benchmarks/quality_common.py`` builds them, for ``eval_perplexity``.

* ``bank_with_hotset``: the bank of the MoE position ``"0"`` whose lo tier
  is every expert at ``lo_bits`` and whose hi pool holds bf16 copies of
  ``hi_sets[l]`` of layer l (published: the state the controller
  converges to); empty sets give a static bank;
* ``hotness_from_counts``: (L, E) router counts of an evaluation
  workload, the hotness the hot sets are chosen from.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.core import tree as T
from repro_torch.core.ver import ExpertBankQ, build_bank
from repro_torch.models.model import forward_train
from repro_torch.training.train import to_batch


def bank_with_hotset(params: Dict, lo_bits: int,
                     hi_sets: Sequence[Sequence[int]]) -> ExpertBankQ:
    """The bank of MoE position ``"0"`` (a stacked (L, E, K, N) expert
    tree) with ``hi_sets[l]`` (expert ids) in slots 0.. of layer l."""
    experts = params["blocks"]["0"]["moe"]["experts"]
    n_hi = max((len(s) for s in hi_sets), default=0)
    bank = build_bank(experts, n_hi=max(n_hi, 1), lo_bits=lo_bits)
    dev = bank.slot_map.device
    for l, hs in enumerate(hi_sets):
        if not len(hs):
            continue
        e = torch.as_tensor(list(hs), dtype=torch.int64, device=dev)
        slots = torch.arange(len(hs), device=dev)
        bank.slot_map[l, e] = slots.to(torch.int32)
        bank.slot_owner[l, slots] = e.to(torch.int32)
        for n, leaf in bank.hi.items():
            leaf[l, :len(hs)] = experts[n][l, e]
    return bank


def hotness_from_counts(cfg, params: Dict, batches,
                        dispatch: str = "ragged") -> np.ndarray:
    """Router selections of MoE position ``"0"`` over ``batches`` at the
    reference's capacity factor 8: (L, E) int64, summed."""
    agg = None
    dev = T.first_device(params)
    with torch.no_grad():
        for b in batches:
            _, aux = forward_train(params, cfg,
                                   to_batch({"tokens": b["tokens"]}, dev),
                                   capacity_factor=8.0,
                                   remat=False, dispatch=dispatch)
            c = aux["counts"]["0"].long().cpu().numpy()
            agg = c if agg is None else agg + c
    return agg


def hot_sets(hot: np.ndarray, n_hi: int) -> List[List[int]]:
    """The ``n_hi`` most selected experts of each layer, hottest first
    (the reference's ``np.argsort(-hot[l])``, ties in its order)."""
    return [[int(e) for e in np.argsort(-hot[l])[:n_hi]]
            for l in range(hot.shape[0])]
