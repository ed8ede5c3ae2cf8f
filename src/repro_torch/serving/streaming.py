"""Streaming cold start: serve before the checkpoint fully materializes
(the port's counterpart of the reference's ``serving/streaming.py``, in its
on-disk layout, file for file: a directory written by either package
serves in the other).

    <root>/manifest.json                 positions, shapes, quantizer meta
    <root>/base/leaf_*.npy               every non-expert param (bf16
                                         leaves widened to float32,
                                         their dtype in the manifest)
    <root>/lo/p{pos}_l{layer}.npz        PREPACKED lo rows for one layer —
                                         keys "{name}.packed" (E, K/epb, N)
                                         uint8 and "{name}.scales" float32
    <root>/hi/p{pos}_l{layer}_e{e}.npz   one expert's dense rows, float32

Quantization happens at SAVE time (``quant.qtensor.quantize``, byte for
byte the reference's), so a cold start reads ``lo_bits/16`` of the expert
bytes before serving, and the staged rows are bit-identical to what
``build_bank`` produces from the dense weights.

Cold-start sequence (driven by ``DynaExqBackend`` with ``stream=``): router
and attention load from ``base/`` (``load_streaming_params``); the lo tier
backfills through staged copies in hotness order (restored priors when a
hotness snapshot exists); serving opens the moment every lo cell is
materialized; the hi and host tiers keep backfilling lazily, each
promotion's ``ensure_hi`` reading its shard.
"""
from __future__ import annotations

import json
import os
import zipfile
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.fault.inject import TransferFault
from repro_torch.quant.qtensor import quantize


def _flatten(tree: Dict, prefix: str = ""):
    for k in sorted(tree):
        v = tree[k]
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flatten(v, key + "/")
        elif v is None:
            continue
        else:
            yield key, v


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def save_expert_shards(path: str, params: Dict, moe_positions,
                       lo_bits: int = 4, group_size: int = 64) -> None:
    """Write the expert-sharded serving checkpoint. ``params`` must still
    hold dense experts (run before any backend frees them); the experts
    are quantized on their own device, one layer at a time."""
    os.makedirs(os.path.join(path, "lo"), exist_ok=True)
    os.makedirs(os.path.join(path, "hi"), exist_ok=True)
    os.makedirs(os.path.join(path, "base"), exist_ok=True)
    manifest = {"lo_bits": lo_bits, "group_size": group_size,
                "positions": [], "shapes": {}}
    base_keys = []
    for key, leaf in _flatten(params):
        if "/moe/experts/" in key:
            continue
        meta = {"key": key, "dtype": _dtype_name(leaf)}
        arr = leaf.detach().cpu()
        if arr.dtype == torch.bfloat16:             # bf16 → f32 (lossless)
            arr = arr.to(torch.float32)
        np.save(os.path.join(path, "base",
                             f"leaf_{len(base_keys):05d}.npy"), arr.numpy())
        base_keys.append(meta)
    manifest["base"] = base_keys
    for pos in moe_positions:
        pos = str(pos)
        experts = params["blocks"][pos]["moe"]["experts"]
        if experts is None:
            raise ValueError(f"position {pos}: experts already freed")
        names = sorted(experts)
        shapes = {n: list(experts[n].shape) for n in names}
        manifest["positions"].append(pos)
        manifest["shapes"][pos] = shapes
        L, E = shapes[names[0]][:2]
        for l in range(L):
            rows, dense = {}, {}
            for n in names:
                q = quantize(experts[n][l], bits=lo_bits,
                             group_size=group_size)
                rows[f"{n}.packed"] = q.packed.cpu().numpy()
                rows[f"{n}.scales"] = q.scales.to(torch.float32).cpu() \
                    .numpy()
                dense[n] = experts[n][l].to(torch.float32).cpu().numpy()
            np.savez(os.path.join(path, "lo", f"p{pos}_l{l}.npz"), **rows)
            for e in range(E):
                np.savez(os.path.join(path, "hi", f"p{pos}_l{l}_e{e}.npz"),
                         **{n: dense[n][e] for n in names})
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def load_streaming_params(path: str, device=None) -> Dict:
    """Rebuild the params tree from ``base/`` on ``device`` (``cuda`` unless
    ``"cpu"`` is passed) with every MoE position's ``experts`` left as
    ``None``: the banks stream in behind it. This is the ONLY synchronous
    read of a cold start."""
    device = resolve_device(device)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    params: Dict = {}
    for i, meta in enumerate(manifest["base"]):
        arr = np.load(os.path.join(path, "base", f"leaf_{i:05d}.npy"))
        leaf = torch.from_numpy(arr).to(getattr(torch, meta["dtype"])) \
            .to(device)
        node = params
        parts = meta["key"].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    for pos in manifest["positions"]:
        params["blocks"][pos]["moe"]["experts"] = None
    return params


class ShardSource:
    """Loader half of the streaming cold start: per-layer prepacked lo rows
    and per-expert dense hi rows, with read accounting (the bytes read
    before the first token come from here)."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, "manifest.json")) as f:
            self.manifest = json.load(f)
        self.lo_bits = int(self.manifest["lo_bits"])
        self.group_size = int(self.manifest["group_size"])
        self.positions: List[str] = list(self.manifest["positions"])
        self.stats = {"lo_reads": 0, "hi_reads": 0, "bytes_read": 0,
                      "fault_stall_s": 0.0}
        # Fault injection (``shard_lo``/``shard_hi`` sites): missing and
        # corrupt npz files — injected or real — surface as retryable
        # `TransferFault`s; the retry loop lives in the consuming
        # ``HostExpertStore`` loaders.
        self.injector = None

    def shapes(self, pos) -> Dict[str, tuple]:
        return {n: tuple(s)
                for n, s in self.manifest["shapes"][str(pos)].items()}

    def _fire(self, site: str, **ctx) -> None:
        if self.injector is None:
            return
        f = self.injector.fire(site, **ctx)
        if f is None:
            return
        if f.kind == "stall":
            self.stats["fault_stall_s"] += f.stall_s   # modeled slow read
            return
        raise TransferFault(site, kind=f.kind, seq=f.seq)

    def _read_npz(self, site: str, path: str) -> Dict[str, np.ndarray]:
        try:
            with np.load(path) as z:
                return {k: z[k] for k in z.files}
        except (OSError, ValueError, zipfile.BadZipFile, KeyError) as e:
            # Missing or corrupt shard on disk: the same retryable surface
            # as an injected fault, so one degradation path covers both.
            raise TransferFault(site, detail=f"{path}: {e}") from e

    def lo_layer(self, pos, layer: int) -> Dict[str, np.ndarray]:
        self._fire("shard_lo", pos=str(pos), layer=layer)
        rows = self._read_npz("shard_lo", os.path.join(
            self.path, "lo", f"p{pos}_l{layer}.npz"))
        self.stats["lo_reads"] += 1
        self.stats["bytes_read"] += sum(a.nbytes for a in rows.values())
        return rows

    def hi_expert(self, pos, layer: int, expert: int
                  ) -> Dict[str, np.ndarray]:
        self._fire("shard_hi", pos=str(pos), layer=layer, expert=expert)
        rows = self._read_npz("shard_hi", os.path.join(
            self.path, "hi", f"p{pos}_l{layer}_e{expert}.npz"))
        self.stats["hi_reads"] += 1
        self.stats["bytes_read"] += sum(a.nbytes for a in rows.values())
        return rows

    def load_dense_experts(self, pos, device=None) -> Dict[str, torch.Tensor]:
        """Materialize one position's FULL dense bf16 experts from the hi
        shards on ``device`` (``cuda`` unless ``"cpu"`` is passed): the
        no-streaming baseline, which reads every shard up front."""
        device = resolve_device(device)
        shapes = self.shapes(pos)
        names = sorted(shapes)
        L, E = shapes[names[0]][:2]
        out = {n: torch.empty(tuple(shapes[n]), dtype=torch.bfloat16)
               for n in names}
        for l in range(L):
            for e in range(E):
                rows = self.hi_expert(pos, l, e)
                for n in names:
                    out[n][l, e].copy_(torch.from_numpy(rows[n]))
        return {n: a.to(device) for n, a in out.items()}


def hotness_stage_order(scores: Optional[np.ndarray], L: int,
                        E: int) -> List[tuple]:
    """Cold-start staging order for one position's (layer, expert) cells:
    hottest-first when a restored hotness snapshot exists (previous run's
    traffic), deterministic row-major otherwise."""
    if scores is None or scores.shape != (L, E) or not scores.any():
        return [(l, e) for l in range(L) for e in range(E)]
    flat = np.argsort(-scores.reshape(-1), kind="stable")
    return [(int(i) // E, int(i) % E) for i in flat]
