"""Roofline terms of the port on NVIDIA H100 SXM cards.

Two halves, as the reference's ``launch/roofline.py``. The analytic half:
the model's FLOPs per token, the expected active experts of a uniform
router, and the expert-weight bytes per token one MoE forward must stream
(``predict_moe_bytes_per_token``), the prediction the trace cost model
(``obs.costmodel``) holds the measured traffic to. The artifact half
reads what the dry run (``launch.dryrun``) records of one rank's step,
where the reference reads XLA's compiled artifacts:

    compute    = FLOPs / PEAK_FLOPS           (counted op by op, + kernels)
    memory     = bytes accessed / HBM_BW      (each op's operands, unfused)
    collective = Σ_axis sent bytes / LINK_BW  (``launch.dist.SENT_BYTES``)

all in seconds per step on one card. ``op_bytes`` and ``convert_bytes``
price one dispatched op; ``collective_bytes`` reads the sent bytes;
``Roofline`` and ``analyze`` assemble the terms. Every figure here is a
data-sheet figure of the H100 SXM and its links, not a measurement.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

PEAK_FLOPS = 989e12         # bf16 dense, H100 SXM (data sheet)
HBM_BW = 3.35e12            # bytes/s, H100 SXM HBM3 (data sheet)
#: Bytes/s one card sends over each kind of link, one direction (data
#: sheets, not measured): NVLink 4 on the H100 SXM, 900 GB/s both ways
#: together; InfiniBand NDR, one 400 Gb/s ConnectX-7 port per card as in
#: a DGX H100. An axis whose ranks sit in one 8-card node (``NODE_CARDS``)
#: runs on NVLink, any other (the production grids' model axis of 16
#: spans two nodes) on InfiniBand.
LINK_BW = {"nvlink": 450e9, "infiniband": 50e9}
NODE_CARDS = 8
#: Card memory of the H100 SXM 80 GB.
HBM_BYTES = 80 * (1 << 30)


def model_flops(cfg, kind: str, tokens: int) -> float:
    """6·N·D for training, 2·N_active·D for an inference forward."""
    n_active = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n_active * tokens
    return 2.0 * n_active * tokens


def expected_active_experts(tokens: float, num_experts: int,
                            top_k: int) -> float:
    """Coupon-collector expectation: distinct experts activated by
    ``tokens`` independent top-k draws under a uniform router —
    ``E · (1 − (1 − k/E)^T)``. Real (skewed, temporally correlated) routing
    activates fewer; the gap is what the trace-driven cost model
    (``obs.costmodel``) measures as a residual."""
    if tokens <= 0:
        return 0.0
    E = float(num_experts)
    return E * (1.0 - (1.0 - top_k / E) ** tokens)


def predict_moe_bytes_per_token(tokens: float, layers: int, num_experts: int,
                                top_k: int, lo_bytes: int, hi_bytes: int,
                                published_hi: int = 0,
                                dispatch: str = "ragged") -> float:
    """Analytic expert-weight HBM traffic of ONE MoE forward, per routed
    token — the prediction the flight-recorder replay validates.

    ``layers`` is the number of MoE layer-steps in the forward (all
    positions × superblocks); ``published_hi`` the total published hi cells
    across those layers. ``padded`` streams every layer's full lo tier plus
    every published hi slot regardless of routing; ``ragged`` streams only
    the expected active experts at their resident tier (hi cells assumed
    uniformly spread, i.e. hit proportionally to their population)."""
    if tokens <= 0 or layers <= 0:
        return 0.0
    if dispatch == "padded":
        total = layers * num_experts * lo_bytes + published_hi * hi_bytes
        return total / tokens
    act = expected_active_experts(tokens, num_experts, top_k)
    hi_frac = published_hi / float(layers * num_experts)
    act_hi = act * hi_frac
    act_lo = act - act_hi
    return layers * (act_lo * lo_bytes + act_hi * hi_bytes) / tokens


# ---- the artifact half: what the dry run records ------------------------
def axis_ranks(grid, axis: str, rank: int = 0) -> list:
    """The ranks of ``rank``'s group on ``axis`` ("model", "data" or
    "tokens") of ``grid`` (data-major: rank = i · n_model + j, every
    non-model axis one data axis)."""
    nm = grid.shape["model"]
    n = 1
    for a in grid.axis_names:
        n *= grid.shape[a]
    i, j = divmod(rank, nm)
    if axis == "model":
        return [i * nm + m for m in range(nm)]
    if axis == "data":
        return list(range(j, n, nm))
    return list(range(n))


def link_bw(grid, axis: str) -> float:
    """``LINK_BW`` of the links ``axis`` of ``grid`` runs on: NVLink where
    its ranks share one node of ``NODE_CARDS`` cards, else InfiniBand."""
    nodes = {r // NODE_CARDS for r in axis_ranks(grid, axis)}
    return LINK_BW["nvlink" if len(nodes) == 1 else "infiniband"]


#: Ops that touch no memory: allocations without a fill.
_NO_TRAFFIC = frozenset({"empty", "empty_like", "empty_strided",
                         "new_empty", "new_empty_strided", "_unsafe_view"})
#: In-place ops that overwrite their first argument without reading it.
_OVERWRITE = frozenset({"copy_", "fill_", "zero_"})
#: Indexed writes: they read their indices and values and write the
#: values' positions of the destination, not all of it.
_INDEXED = frozenset({"index_put_", "index_put", "_index_put_impl_",
                      "scatter_", "scatter", "scatter_add_", "scatter_add",
                      "index_copy_", "index_add_", "index_fill_"})


def _tensors(tree) -> list:
    """The tensors of an op's arguments or results, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes a tensor's elements span: its elements, or its storage
    where that is smaller (a broadcast view reads its storage once)."""
    n = t.numel() * t.element_size()
    return min(n, t.untyped_storage().nbytes())


def op_bytes(func, args, kwargs, out) -> int:
    """The bytes one dispatched aten op accesses as issued: every input
    read and every output written once (an unfused upper bound: a fused
    kernel keeps its intermediates on chip). Views and bare allocations
    move nothing; ``copy_``/``fill_``/``zero_`` do not read what they
    overwrite; an indexed write reads its indices and values and writes
    only the values' positions."""
    name = func.overloadpacket.__name__
    if func.is_view or name in _NO_TRAFFIC:
        return 0
    ins = _tensors((args, kwargs))
    if name in _INDEXED:
        rest = ins[1:]
        return sum(map(tensor_bytes, rest)) + tensor_bytes(rest[-1])
    if name in _OVERWRITE:
        ins = ins[1:]
    return sum(map(tensor_bytes, ins)) + sum(map(tensor_bytes,
                                                 _tensors(out)))


def convert_bytes(func, args, kwargs, out) -> int:
    """The bytes of one dtype cast issued as an op of its own
    (``aten._to_copy`` to another dtype): its input read and its output
    written. A fused kernel casts in registers; the roofline reports the
    raw bytes and these beside them, as the reference reports its CPU
    HLO's convert traffic."""
    if func.overloadpacket.__name__ != "_to_copy":
        return 0
    src, dst = args[0], out
    if not isinstance(dst, torch.Tensor) or src.dtype == dst.dtype:
        return 0
    return tensor_bytes(src) + tensor_bytes(dst)


def collective_bytes(sent: Dict[str, Dict[str, int]]) -> Dict[str, Dict[str,
                                                                       int]]:
    """The bytes one rank SENT, by collective and axis, without the zeros
    (``launch.dist.SENT_BYTES`` as the dry run recorded it: a rank's own
    block not counted, an all-reduce priced as a ring's 2(N−1)/N of the
    buffer). The reference sums the result shapes of the compiled HLO's
    collectives instead (what a rank receives and keeps, its own block
    included): the two are not the same measure."""
    return {c: {a: int(b) for a, b in per.items() if b}
            for c, per in sent.items() if any(per.values())}


@dataclasses.dataclass
class Roofline:
    flops: float                # per-card FLOPs of the step
    hbm_bytes: float            # per-card bytes accessed
    coll_bytes: float           # per-card bytes sent
    coll_detail: Dict[str, int]     # sent bytes by collective
    chips: int
    model_flops: float          # 6·N·D (train) or 2·N_active·D (inference)
    # Sent bytes by axis and the link rate each runs on (``link_bw``).
    coll_axes: Dict[str, int] = dataclasses.field(default_factory=dict)
    axis_bw: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return sum(b / self.axis_bw[a] for a, b in self.coll_axes.items())

    @property
    def bottleneck(self) -> str:
        t = {"compute": self.t_compute, "memory": self.t_memory,
             "collective": self.t_collective}
        return max(t, key=t.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    def row(self) -> dict:
        """The reference's row, its keys kept so that the records line up
        (``hlo_gflops_per_chip`` holds the counted FLOPs: there is no HLO
        here)."""
        return {
            "t_compute_s": round(self.t_compute, 6),
            "t_memory_s": round(self.t_memory, 6),
            "t_collective_s": round(self.t_collective, 6),
            "bottleneck": self.bottleneck,
            "hlo_gflops_per_chip": round(self.flops / 1e9, 2),
            "hbm_gb_per_chip": round(self.hbm_bytes / 1e9, 3),
            "coll_mb_per_chip": round(self.coll_bytes / 1e6, 3),
            "model_gflops_total": round(self.model_flops / 1e9, 2),
            "useful_flops_ratio": round(self.useful_flops_ratio, 4),
        }


def analyze(costs: dict, sent: Dict[str, Dict[str, int]], cfg, kind: str,
            tokens: int, grid) -> Roofline:
    """The roofline terms of one rank's step from what the dry run
    recorded: ``costs`` {"flops", "bytes"} (the dispatched ops' and the
    kernels' own), ``sent`` the rank's ``SENT_BYTES``; ``grid`` the
    planner's grid (its cards and the links of each axis)."""
    detail = collective_bytes(sent)
    axes: Dict[str, int] = {}
    for per in detail.values():
        for a, b in per.items():
            axes[a] = axes.get(a, 0) + b
    chips = 1
    for v in grid.shape.values():
        chips *= v
    return Roofline(flops=float(costs["flops"]),
                    hbm_bytes=float(costs["bytes"]),
                    coll_bytes=float(sum(axes.values())),
                    coll_detail={c: sum(per.values())
                                 for c, per in detail.items()},
                    chips=chips,
                    model_flops=model_flops(cfg, kind, tokens),
                    coll_axes=axes,
                    axis_bw={a: link_bw(grid, a) for a in axes})
