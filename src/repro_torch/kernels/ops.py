"""Wrappers of the port's CUDA kernels.

Each wrapper checks device, dtype, shape and contiguity, then:

* for tensors on the CPU, runs the plain version from ``kernels.ref``;
* for CUDA tensors, launches its kernel on the current stream (built at
  first use, see ``kernels.build``) or raises — there is no fallback;

and counts its launches in ``LAUNCHES`` (one per call that launched,
nowhere else), so a run can show that the main path went through the
kernels. The wrappers on the dry run's path (``launch.dryrun``: the
ragged FFN's pair, the grouped GEMM and the dense decode attention) take
``meta`` tensors inside ``launch.dist.dry_run()`` (``_priced``): an empty
output of the kernel's shape, its own FLOPs and bytes priced as it
computes them, no launch counted; the other wrappers refuse ``meta``
(``_card_only``). No kernel has a backward: every wrapper raises while
autograd records and an input requires a gradient (``_no_grad_inputs``).
The two decode-attention wrappers count one per call whether one or two
device launches ran: they are split-KV (``decode_splits`` cuts each row's
tiles across CTAs, and a second small kernel merges the splits when there
is more than one).

The padded MoE dispatch's grouped GEMM (``grouped_lo_matmul``), the dense
decode attention (``flash_decode``) and the plain quantized GEMM
(``quant_matmul_op``) keep the reference's names. The two GEMMs run one
kernel (the ragged FFN's tensor-core main loop); ``gemm_plan`` picks, from
shapes alone, how many 8-row chunks a warp pass multiplies, whether K is
cut across CTAs (then a second small kernel adds the ranges in order; one
``LAUNCHES`` count) and in how many pieces a CTA walks its range. The
ragged FFN's two kernels read the per-tile maps ``tile_eid`` /
``tile_slot`` directly: the Pallas version's DMA hold maps (``_hold_last``)
have no counterpart here. Their all-hi mode (``ragged_dense_ffn``: every
tile on its expert's dense bf16 weights, for the fp16 and offload
backends) is a kernel of its own (``csrc/ragged_dense_ffn.cu``): runs of
up to ``DENSE_NT`` tiles of one expert share each weight read, a
persistent grid walks (run, column block) items, and TMA loads fill a
ring shared by the CTA, through tensor maps cached here by
``tensor_map_key``. A run stays within a segment of equal ids of
``tile_eid``, so any tile order is computed (``dense_runs`` mirrors the
kernel's runs). Where the reference's ``ragged_dense_ffn_op`` runs its
oracle for a shape its kernel cannot tile, these wrappers copy the
operands, zero-padded to whole k16 steps and 64-column boxes, and run the
kernel all the same (``dense_route``, decided before any launch).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import ref

#: Launch counts per kernel (plain integers; ``reset_launches`` zeroes them).
LAUNCHES: Dict[str, int] = {"ragged_gateup": 0, "ragged_down": 0,
                            "ragged_dense_gateup": 0,
                            "ragged_dense_down": 0,
                            "flash_decode_paged": 0, "grouped_lo_matmul": 0,
                            "flash_decode": 0, "quant_matmul": 0}

#: Row tile of the ragged kernels (compiled in).
KERNEL_BM = 8
#: Output columns per CTA of the quantized GEMM kernels (N must be a
#: multiple).
KERNEL_BN = 64
#: Head widths the decode-attention kernels are compiled for (their
#: register tiles are sized at compile time). Any other multiple of 8 up to
#: the largest runs on the next one, its columns zero-padded in shared
#: memory (``decode_width``; e.g. Danube's 120 on 128).
DECODE_HEAD_DIMS = (64, 128, 256)
#: Most query heads per KV head the decode-attention kernels take (the 16
#: M rows of one ``mma.sync``).
DECODE_MAX_REP = 16
#: Sequence positions per tile of the dense decode kernel (compiled in).
DECODE_TILE = 32
#: Warps per CTA of the decode-attention kernels (compiled in); each warp
#: takes every 4th tile of its CTA's split.
DECODE_WARPS = 4
#: The decode-attention split rule aims at this many CTAs per SM, over
#: splits of at least ``DECODE_MIN_TILES`` tiles each.
DECODE_WAVES = 1
DECODE_MIN_TILES = 2


#: Chunks of 8 rows one warp pass of the GEMM kernels multiplies with each
#: decoded weight fragment (compiled in).
GEMM_NT = (1, 2, 4)
#: Output columns per CTA of the GEMM kernels: 4 warps of two 16-column
#: blocks (compiled in).
GEMM_CTA_N = 128
#: The GEMM plan's targets (from the sweep of ``chip_smoke.py --only
#: card,build,gemms`` on the H100): about this many CTAs per SM before K
#: is cut across CTAs, and at most this much shared memory per CTA (the
#: activation tile is walked in pieces until it fits, so ~3 CTAs share an
#: SM).
GEMM_WAVES = 2
GEMM_CTA_SMEM = 60 * 1024
#: The per-warp ring bytes of the GEMM kernels' layout (``qmma::RING``).
_GEMM_RING = 4 * 512

#: Most tiles per run of the all-hi kernels (compiled in: ``NT`` of
#: ``csrc/ragged_dense_ffn.cu``): a run's rows share each weight read.
DENSE_NT = 8
#: Columns per TMA weight box of the all-hi kernels (compiled in): N must
#: be a multiple.
DENSE_BN = 64
#: Each all-hi kernel's consumer warps per CTA (16 columns each, so a work
#: item covers 16 × this many columns; compiled for 4 and 8) and ring
#: slots (2 … 16), chosen by ``chip_smoke.py --only card,build,dense`` on
#: the H100.
DENSE_PLAN = {"ragged_dense_gateup": (4, 2), "ragged_dense_down": (8, 2)}
#: Shared memory a CTA may have (``SMEM_MAX`` of the kernels).
SMEM_MAX = 227 * 1024
#: The all-hi kernels' TMA boxes, innermost dimension first: 64 K values ×
#: 8 rows (one tile) of the activations; 64 columns × 64 K rows × one
#: expert of a bank (compiled in).
DENSE_X_BOX = (64, 8)
DENSE_W_BOX = (64, 64, 1)
#: Most tiles the all-hi kernels take: each CTA keeps two ints per tile
#: (a map of Tt tiles has at most Tt segments) in shared memory beside its
#: ring.
DENSE_MAX_TILES = 16384
#: Tensor maps (128-byte buffers) by ``tensor_map_key``; cleared when it
#: holds ``_TMAP_CAP`` of them.
_TMAPS: Dict[tuple, ctypes.Array] = {}
_TMAP_CAP = 256


def dense_smem_bytes(nmat: int, warps: int, stages: int, Tt: int) -> int:
    """Shared memory of one all-hi CTA over a map of ``Tt`` tiles
    (``smem_bytes`` of the kernels): 1 KB of alignment slack, ``stages``
    slots of ``warps / 4`` 8 KB weight boxes per matrix and 8 tiles' 1 KB
    row boxes, 16 barrier pairs, and per segment two ints (first tile, run
    offset; Tt + 1 of each) plus the scan's 16 warp sums."""
    slot = nmat * (warps // 4) * 8192 + DENSE_NT * 1024
    return 1024 + stages * slot + 16 * 16 + 4 * (2 * (Tt + 1) + 16)


def decode_width(hd: int) -> int:
    """The compiled width a head width runs on in the decode-attention
    kernels (``fd::padded_width``): itself, or the next of
    ``DECODE_HEAD_DIMS``; 0 when none takes it (hd not a multiple of 8, or
    above the largest)."""
    if hd <= 0 or hd % 8 or hd > DECODE_HEAD_DIMS[-1]:
        return 0
    return next(w for w in DECODE_HEAD_DIMS if w >= hd)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def decode_splits(B: int, Hkv: int, n_tiles: int,
                  n_sm: int) -> Tuple[int, int]:
    """How the decode-attention kernels cut each (row, KV head)'s
    ``n_tiles`` tiles across CTAs: returns ``(n_split, tiles_per_split)``.
    Split ``s`` takes tiles ``[s·tps, min(n_tiles, (s+1)·tps))``; every
    split is non-empty and together they cover each tile once. Enough
    splits for about ``DECODE_WAVES`` CTAs per SM over the B·Hkv groups, at
    least ``DECODE_MIN_TILES`` tiles each; 1 when B·Hkv alone gives that
    many CTAs. A split of more tiles than a CTA has warps takes a whole
    number per warp, so its warps end together. On the H100 more splits
    than one CTA per SM cost more in the merge than they gain, and uneven
    warps cost ~10% (``chip_smoke.py --only card,build,splits``). A
    function of shapes only, so a result never depends on data or
    timing."""
    rows = max(1, B * Hkv)
    want = -(-DECODE_WAVES * n_sm // rows)
    n = max(1, min(want, n_tiles // DECODE_MIN_TILES))
    tps = max(1, -(-n_tiles // n))
    if DECODE_WARPS < tps < n_tiles:
        tps = min(n_tiles, -(-tps // DECODE_WARPS) * DECODE_WARPS)
    return max(1, -(-n_tiles // tps)), tps


class GemmPlan(NamedTuple):
    """How the GEMM kernels cut an (E, C, K) × (E, K, N) product: ``nt``
    chunks of 8 rows per CTA (a CTA covers rows ``[8·nt·j, 8·nt·(j+1)) ∩
    [0, C)`` and ``GEMM_CTA_N`` columns of one expert); ``n_split`` ranges
    of ``gps`` scale groups across K (range ``z`` covers groups ``[z·gps,
    min(G, (z+1)·gps))``, float32 partials added in order when there are
    several); and pieces of ``gpc`` groups in which a CTA walks its range,
    one activation tile of a piece's width in shared memory."""
    nt: int
    n_split: int
    gps: int
    gpc: int


def gemm_smem_bytes(nt: int, group: int, gpc: int) -> int:
    """Shared memory of one GEMM CTA (``qmma::gemm_smem_bytes``): the
    activation tile (8·nt rows of gpc·group + 8 bf16), then for each of
    the 4 warps' two 16-column blocks a ring and the columns' scales."""
    return nt * 8 * (gpc * group + 8) * 2 + 8 * (_GEMM_RING + gpc * 16 * 2)


def gemm_piece(nt: int, group: int, gps: int) -> int:
    """Groups per piece: ``gps`` halved (rounded up) until a CTA's shared
    memory is at most ``GEMM_CTA_SMEM``."""
    gpc = gps
    while gpc > 1 and gemm_smem_bytes(nt, group, gpc) > GEMM_CTA_SMEM:
        gpc = -(-gpc // 2)
    return gpc


def ragged_smem_bytes(nmat: int, group: int, gpc: int) -> int:
    """Shared memory of one ragged FFN CTA over pieces of ``gpc`` scale
    groups (``smem_bytes`` of ``csrc/ragged_ffn.cu``): the activation
    tile's piece (8 rows of gpc·group + 8 bf16), then for each of the 4
    warps and ``nmat`` matrices a ring and the columns' scales."""
    return 8 * (gpc * group + 8) * 2 + 4 * nmat * (_GEMM_RING + gpc * 16 * 2)


def ragged_piece(nmat: int, K: int, group: int) -> int:
    """Scale groups per piece of K in the ragged FFN kernels
    (``piece_groups`` of ``csrc/ragged_ffn.cu``): all ``K // group`` when
    they fit ``SMEM_MAX`` (one piece: the shapes that fitted before K was
    walked in pieces sum as they did), else the fewest pieces that fit,
    equal but the last. Raises a ``ValueError`` naming K when not
    even one group fits."""
    G = K // group
    most = 0
    while most < G and ragged_smem_bytes(nmat, group, most + 1) <= SMEM_MAX:
        most += 1
    if most == 0:
        raise ValueError(
            f"K={K}: one scale group of {group} needs "
            f"{ragged_smem_bytes(nmat, group, 1)} B of shared memory, above "
            f"the {SMEM_MAX} B a CTA may have")
    n = -(-G // most)
    return -(-G // n)


def gemm_plan(E: int, C: int, K: int, N: int, group: int,
              n_sm: int) -> GemmPlan:
    """The launch shape of the grouped and plain quantized GEMMs, from
    shapes alone. NT = 1 while C fits one chunk (decode), else the largest
    of ``GEMM_NT`` that C fills (more rows per decoded weight fragment);
    then K is cut into enough ranges for about ``GEMM_WAVES`` CTAs per SM
    (none when the (expert, rows, columns) CTAs alone are that many), and
    each range into pieces by ``gemm_piece``. Every range and piece is
    non-empty."""
    chunks = max(1, -(-C // 8))
    nt = max(n for n in GEMM_NT if n <= chunks)
    ctas = max(1, E * -(-chunks // nt) * -(-N // GEMM_CTA_N))
    G = max(1, K // group)
    n = max(1, min(G, GEMM_WAVES * n_sm // ctas))
    gps = -(-G // n)
    return GemmPlan(nt, -(-G // gps), gps, gemm_piece(nt, group, gps))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class _DecodePlan:
    """The shape-only part of a decode-attention launch, built once per
    shape: the split, the size of the float32 partials (none with one
    split) and the kernel's integer arguments as a C array."""

    def __init__(self, library: str, B: int, H: int, Hkv: int, hd: int,
                 n_tiles: int, index: int, dims) -> None:
        from repro_torch.kernels import build
        self.n_split, self.tps = decode_splits(B, Hkv, n_tiles,
                                               _sm_count(index))
        # acc (B·Hkv, n_split, rep, hd), then (m, l) (B·Hkv, n_split, rep, 2).
        self.scratch = 0 if self.n_split == 1 else \
            B * Hkv * self.n_split * (H // Hkv) * (hd + 2)
        self.shape = (B, H, hd)
        self.scale = hd ** -0.5
        self.dims = (ctypes.c_longlong * (len(dims) + 2))(
            *dims, self.n_split, self.tps)
        self.dims_ptr = ctypes.addressof(self.dims)
        lib = build.library(library)
        self.fn = getattr(lib, library)
        self.fn_lse = getattr(lib, f"{library}_lse", None)


#: Launch plans by (library, shapes, strides, device): built on a shape's
#: first call, after the checks that depend on shapes alone.
_PLANS: Dict[tuple, _DecodePlan] = {}


def _new_plan(key: tuple, q, Hkv: int, n_tiles: int, dims) -> _DecodePlan:
    B, H, hd = q.shape
    if not decode_width(hd) or H // Hkv > DECODE_MAX_REP:
        raise ValueError(f"the CUDA kernel takes hd a multiple of 8 up to "
                         f"{DECODE_HEAD_DIMS[-1]} (register tiles sized at "
                         f"compile time) and at most {DECODE_MAX_REP} query "
                         f"heads per KV head; got hd={hd}, {H // Hkv} per "
                         f"KV head")
    plan = _PLANS[key] = _DecodePlan(key[0], B, H, Hkv, hd, n_tiles,
                                     q.device.index, dims)
    return plan


def _decode_launch(plan: _DecodePlan, name: str, q, k, v, *rest,
                   lse: bool = False):
    """Allocate the output (and the partials when there are several
    splits), launch, count. ``lse``: the dense kernel's entry that also
    writes each head's log-sum-exp; returns (out, lse (B, H) float32)."""
    pk, pv = k.data_ptr(), v.data_ptr()
    if pk % 16 or pv % 16 or q.data_ptr() % 4:
        raise ValueError("the CUDA kernel copies K/V in 16-byte chunks: k "
                         "and v must start 16-byte aligned (q 4-byte)")
    out = torch.empty(plan.shape, dtype=torch.bfloat16, device=q.device)
    scratch = None if not plan.scratch else torch.empty(
        plan.scratch, dtype=torch.float32, device=q.device)
    ptrs = [q.data_ptr(), pk, pv, *[t.data_ptr() for t in rest],
            out.data_ptr()]
    if lse:
        lse_t = torch.empty(plan.shape[:2], dtype=torch.float32,
                            device=q.device)
        err = plan.fn_lse(*ptrs, lse_t.data_ptr(), _ptr(scratch),
                          plan.dims_ptr, plan.scale, _stream(q.device.index))
    else:
        err = plan.fn(*ptrs, _ptr(scratch), plan.dims_ptr, plan.scale,
                      _stream(q.device.index))
    if err:
        from repro_torch.kernels import build
        build.check(err, name)
    LAUNCHES[name] += 1
    return (out, lse_t) if lse else out


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(index: Optional[int] = None) -> int:
    """The current CUDA stream of device ``index`` (default: the current
    device) as an integer handle, without building a ``Stream`` object."""
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)


def _need(t: torch.Tensor, name: str, dtype, device, ndim: int,
          contiguous: bool = True) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()}-d, expected {ndim}-d")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _nb(*tensors) -> int:
    """The bytes of ``tensors`` (None counts 0)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _priced(name: str, shape, device, flops: int, nbytes: int,
            dtype=torch.bfloat16) -> torch.Tensor:
    """The ``meta`` branch of a kernel on the dry run's path: its FLOPs and
    the bytes it moves (each operand read and each output written as the
    kernel's grid reads and writes them) added to the active
    ``launch.dist.dry_run()``, which raises outside one, and an empty
    ``meta`` output of the kernel's shape. Nothing launches, so
    ``LAUNCHES`` is not counted."""
    from repro_torch.launch import dist
    dist.record_kernel(name, flops, nbytes)
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def _card_only(dev: torch.device, name: str) -> None:
    """A kernel on no path of the dry run takes no ``meta`` tensor."""
    if dev.type == "meta":
        raise ValueError(f"{name}: no meta branch (the kernel is on no path "
                         f"of the dry run)")


def _lo_per_expert(packed, scales) -> int:
    """The lo-tier bytes (codes and scales) of one expert of a bank."""
    return _nb(packed, scales) // packed.shape[0]


def _no_grad_inputs(name: str, *tensors) -> None:
    """The kernels have no backward (neither has the reference's Pallas
    path): a call that autograd would record raises, where its output
    would otherwise carry no ``grad_fn`` and leave its inputs without a
    gradient, silently. The plain versions on the CPU obey the same rule."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: an input requires a gradient, and the "
                           f"kernel has no backward; run it under "
                           f"torch.no_grad() (training differentiates the "
                           f"padded dispatch's plain products)")


def _check_codes(packed, scales, K: int, bits: int, group: int, dev,
                 ndim: int):
    """The lo codes (..., K//epb, N) uint8 and scales (..., K//g, N) bf16
    of one (ndim 2) or E (ndim 3) weights; returns N."""
    if bits not in (2, 4, 8) or group % (8 // bits) or K % group:
        raise ValueError(f"K={K} not tileable by group {group} at "
                         f"{bits} bits")
    _need(packed, "packed", torch.uint8, dev, ndim)
    _need(scales, "scales", torch.bfloat16, dev, ndim)
    if packed.shape[-2] * (8 // bits) != K or scales.shape != \
            packed.shape[:-2] + (K // group, packed.shape[-1]):
        raise ValueError(f"lo weights {tuple(packed.shape)}/"
                         f"{tuple(scales.shape)} do not match K={K}, "
                         f"bits={bits}, g={group}")
    return packed.shape[-1]


def _check_ragged(x, tile_eid, tile_slot, n_tiles, packed, scales, hi,
                  bits, group, bm, names):
    dev = x.device
    _need(x, names[0], torch.bfloat16, dev, 2)
    _need(tile_eid, "tile_eid", torch.int32, dev, 1)
    _need(tile_slot, "tile_slot", torch.int32, dev, 1)
    _need(n_tiles, "n_tiles", torch.int32, dev, 1)
    if n_tiles.numel() != 1:
        raise ValueError("n_tiles must hold one element")
    Tt = tile_eid.shape[0]
    if tile_slot.shape != (Tt,):
        raise ValueError("tile_slot must match tile_eid")
    R, K = x.shape
    if R != Tt * bm:
        raise ValueError(f"{names[0]} rows {R} != tiles {Tt} × bm {bm}")
    N = None
    for p, s in zip(packed, scales):
        n = _check_codes(p, s, K, bits, group, dev, 3)
        N = n if N is None else N
        if n != N:
            raise ValueError("lo weights disagree on N")
    for h in hi:
        if h is None:
            continue
        _need(h, "hi", torch.bfloat16, dev, 3)
        if h.shape[1:] != (K, N):
            raise ValueError(f"hi weights {tuple(h.shape)} != (n_hi, {K}, "
                             f"{N})")
    return Tt, K, N


def _cuda_shape_rules(bm: int, N: int, group: int, *tensors) -> None:
    """What the ragged CUDA kernels take beyond the plain versions: bm = 8
    token rows (the mma's N), and the rules of ``_mma_shape_rules``."""
    if bm != KERNEL_BM:
        raise ValueError(f"the CUDA kernels are built for bm={KERNEL_BM}, "
                         f"got {bm}")
    _mma_shape_rules(N, group, *tensors)


def _mma_shape_rules(N: int, group: int, *tensors) -> None:
    """What every kernel on the tensor-core main loop (``quant_mma.cuh``:
    the ragged FFN and both quantized GEMMs) takes beyond the plain
    versions: N a multiple of the 64-column CTA block, a scale group of
    whole k16 mma steps, and 16-byte aligned activations, weights and
    scales (copied in 16-byte chunks)."""
    if N % KERNEL_BN:
        raise ValueError(f"N={N} not a multiple of {KERNEL_BN}")
    if group % 16:
        raise ValueError(f"group={group}: the CUDA kernels take a multiple "
                         f"of 16 (a scale group is whole k16 mma steps)")
    if any(t is not None and t.data_ptr() % 16 for t in tensors):
        raise ValueError("the CUDA kernels copy activations, weights and "
                         "scales in 16-byte chunks: they must start 16-byte "
                         "aligned")


def _gemm_shape_rules(K: int, N: int, group: int, *tensors) -> None:
    """What the GEMM kernels take beyond the plain versions: K whole scale
    groups (the CTAs cut K at group boundaries), and the rules of
    ``_mma_shape_rules``."""
    if K % group:
        raise ValueError(f"K={K} not a multiple of group={group}")
    _mma_shape_rules(N, group, *tensors)


def ragged_gateup(xs, tile_eid, tile_slot, n_tiles, gate_packed, gate_scales,
                  up_packed, up_scales, hi_gate=None, hi_up=None, *,
                  bits: int, group: int, bm: int) -> torch.Tensor:
    """h (R, F) = bf16(silu(xs·W_gate)) · bf16(xs·W_up) per row tile on its
    tier (hi slot when ``tile_slot >= 0`` and a hi pool is given, else the
    packed lo codes). Rows of tiles ``t >= n_tiles`` are not written on the
    card."""
    _no_grad_inputs("ragged_gateup", xs, gate_scales, up_scales, hi_gate,
                    hi_up)
    n_hi = 0 if hi_gate is None else hi_gate.shape[0]
    if n_hi == 0:
        hi_gate = hi_up = None
    Tt, K, F = _check_ragged(xs, tile_eid, tile_slot, n_tiles,
                             (gate_packed, up_packed),
                             (gate_scales, up_scales), (hi_gate, hi_up),
                             bits, group, bm, ("xs",))
    if xs.device.type == "meta":
        # Every one of the Tt tiles the grid launches, on its expert's lo
        # codes (a meta run sees no routing, and the dry run's bank
        # publishes no hi slot): an upper bound on the tiles.
        R = Tt * bm
        w = Tt * (_lo_per_expert(gate_packed, gate_scales) +
                  _lo_per_expert(up_packed, up_scales))
        return _priced("ragged_gateup", (R, F), xs.device, 4 * R * K * F,
                       _nb(xs, tile_eid, tile_slot, n_tiles) + 2 * R * F + w)
    if xs.device.type == "cpu":
        return ref.ragged_gateup_ref(xs, tile_eid, tile_slot, gate_packed,
                                     gate_scales, up_packed, up_scales,
                                     hi_gate, hi_up, bits=bits, group=group,
                                     bm=bm)
    _cuda_shape_rules(bm, F, group, xs, gate_packed, gate_scales, up_packed,
                      up_scales, hi_gate, hi_up)
    ragged_piece(2, K, group)
    from repro_torch.kernels import build
    h = torch.empty((Tt * bm, F), dtype=torch.bfloat16, device=xs.device)
    err = build.library("ragged_ffn").ragged_gateup(
        xs.data_ptr(), tile_eid.data_ptr(), tile_slot.data_ptr(),
        n_tiles.data_ptr(), gate_packed.data_ptr(), gate_scales.data_ptr(),
        up_packed.data_ptr(), up_scales.data_ptr(), _ptr(hi_gate),
        _ptr(hi_up), h.data_ptr(), Tt, K, F, n_hi, bits, group, _stream())
    build.check(err, "ragged_gateup")
    LAUNCHES["ragged_gateup"] += 1
    return h


def ragged_down(h, tile_eid, tile_slot, n_tiles, down_packed, down_scales,
                hi_down=None, *, bits: int, group: int,
                bm: int) -> torch.Tensor:
    """y (R, D) = h · W_down per row tile on its tier."""
    _no_grad_inputs("ragged_down", h, down_scales, hi_down)
    n_hi = 0 if hi_down is None else hi_down.shape[0]
    if n_hi == 0:
        hi_down = None
    Tt, F, D = _check_ragged(h, tile_eid, tile_slot, n_tiles,
                             (down_packed,), (down_scales,), (hi_down,),
                             bits, group, bm, ("h",))
    if h.device.type == "meta":
        R = Tt * bm                         # as ragged_gateup's branch
        return _priced("ragged_down", (R, D), h.device, 2 * R * F * D,
                       _nb(h, tile_eid, tile_slot, n_tiles) + 2 * R * D +
                       Tt * _lo_per_expert(down_packed, down_scales))
    if h.device.type == "cpu":
        return ref.ragged_down_ref(h, tile_eid, tile_slot, down_packed,
                                   down_scales, hi_down, bits=bits,
                                   group=group, bm=bm)
    _cuda_shape_rules(bm, D, group, h, down_packed, down_scales, hi_down)
    ragged_piece(1, F, group)
    from repro_torch.kernels import build
    y = torch.empty((Tt * bm, D), dtype=torch.bfloat16, device=h.device)
    err = build.library("ragged_ffn").ragged_down(
        h.data_ptr(), tile_eid.data_ptr(), tile_slot.data_ptr(),
        n_tiles.data_ptr(), down_packed.data_ptr(), down_scales.data_ptr(),
        _ptr(hi_down), y.data_ptr(), Tt, F, D, n_hi, bits, group, _stream())
    build.check(err, "ragged_down")
    LAUNCHES["ragged_down"] += 1
    return y


def ragged_quant_ffn(xs, tile_eid, tile_slot, n_tiles, lo: dict,
                     hi: Optional[dict], *, bits: int, group: int,
                     bm: int) -> torch.Tensor:
    """The ragged mixed-precision SwiGLU FFN (the two kernels in turn).
    ``lo``: name → object with ``.packed``/``.scales`` (E, ...); ``hi``:
    name → (n_hi, K, N) bf16, or None for an all-lo bank. Returns (R, D)."""
    hg = hu = hd = None
    if hi is not None and hi["w_gate"].shape[0] > 0:
        hg, hu, hd = hi["w_gate"], hi["w_up"], hi["w_down"]
    h = ragged_gateup(xs, tile_eid, tile_slot, n_tiles,
                      lo["w_gate"].packed, lo["w_gate"].scales,
                      lo["w_up"].packed, lo["w_up"].scales, hg, hu,
                      bits=bits, group=group, bm=bm)
    return ragged_down(h, tile_eid, tile_slot, n_tiles,
                       lo["w_down"].packed, lo["w_down"].scales, hd,
                       bits=bits, group=group, bm=bm)


def _check_dense(x, tile_eid, n_tiles, weights, bm, name):
    """The ragged dense kernels' operands: x (Tt·bm, K) bf16, the tile
    maps, and (E, K, N) bf16 banks of one N; returns (Tt, K, N)."""
    dev = x.device
    _need(x, name, torch.bfloat16, dev, 2)
    _need(tile_eid, "tile_eid", torch.int32, dev, 1)
    _need(n_tiles, "n_tiles", torch.int32, dev, 1)
    if n_tiles.numel() != 1:
        raise ValueError("n_tiles must hold one element")
    Tt = tile_eid.shape[0]
    R, K = x.shape
    if R != Tt * bm:
        raise ValueError(f"{name} rows {R} != tiles {Tt} × bm {bm}")
    for w in weights:
        _need(w, "dense weights", torch.bfloat16, dev, 3)
    E, N = weights[0].shape[0], weights[0].shape[-1]
    for w in weights:
        if tuple(w.shape) != (E, K, N):
            raise ValueError(f"dense weights {tuple(w.shape)} != (E, {K}, "
                             f"{N})")
    return Tt, K, N


def dense_route(bm: int, K: int, N: int, Tt: int, *tensors) -> str:
    """How an all-hi call on the card runs, decided from shapes and
    addresses before any launch: "kernel" on the operands as they are, or
    "copy" when K is not whole k16 mma steps, N not whole 64-column weight
    boxes or an operand not 16-byte aligned (TMA's global addresses): the
    operands are copied, zero-padded to whole steps and boxes, to fresh
    aligned buffers, the kernel runs on the copies (the padding adds only
    zero products) and its output is cut back to N columns. The reference's
    ``ragged_dense_ffn_op`` (``src/repro/kernels/ops.py:158-161``) runs its
    oracle for such shapes instead. Raises ``ValueError`` for what no copy
    fixes: bm other than 8 token rows (the mma's N), more than
    ``DENSE_MAX_TILES`` tiles."""
    if bm != KERNEL_BM:
        raise ValueError(f"the CUDA kernels are built for bm={KERNEL_BM}, "
                         f"got {bm}")
    if Tt > DENSE_MAX_TILES:
        raise ValueError(f"Tt={Tt}: the dense CUDA kernels take at most "
                         f"{DENSE_MAX_TILES} tiles")
    if K % 16 or N % DENSE_BN or any(t.data_ptr() % 16 for t in tensors):
        return "copy"
    return "kernel"


def _dense_call(name: str, bm: int, x, tile_eid, n_tiles,
                weights) -> torch.Tensor:
    """One all-hi kernel on the card by ``dense_route``."""
    K, N = x.shape[1], weights[0].shape[2]
    if dense_route(bm, K, N, tile_eid.shape[0], x, *weights) == "copy":
        Kp, Np = -(-K // 16) * 16, -(-N // DENSE_BN) * DENSE_BN
        pad = torch.nn.functional.pad            # always a fresh tensor
        x = pad(x, (0, Kp - K))
        weights = tuple(pad(w, (0, Np - N, 0, Kp - K)) for w in weights)
    out = ragged_dense_launch(name, x, tile_eid, n_tiles, weights)
    return out if out.shape[1] == N else out[:, :N].contiguous()


def dense_runs(tile_eid: torch.Tensor, n_tiles: int,
               cap: int = DENSE_NT, n_experts: Optional[int] = None) -> list:
    """The all-hi kernels' runs in their order, in plain form: each segment
    (a maximal run of equal ids) of the live tiles ``[0, n_tiles)`` cut
    into runs of at most ``cap`` tiles, as ``(expert, first tile, tiles)``,
    segments in tile order. A sorted map has one segment per expert; an
    expert in two places has two. A work item is a run and a
    ``DENSE_BN``-column block (column blocks fastest). With ``n_experts``,
    raises on an id outside ``[0, n_experts)`` (the kernel traps on
    one)."""
    eid = tile_eid[:n_tiles].tolist()
    if n_experts is not None and any(e < 0 or e >= n_experts for e in eid):
        raise ValueError(f"tile_eid holds ids outside [0, {n_experts})")
    runs, t = [], 0
    while t < len(eid):
        end = t
        while end < len(eid) and eid[end] == eid[t]:
            end += 1
        runs += [(eid[t], t0, min(cap, end - t0))
                 for t0 in range(t, end, cap)]
        t = end
    return runs


def dense_grid(n_sm: int, per_sm: int, Tt: int, n_cb: int) -> int:
    """The all-hi kernels' persistent grid: the CTAs that fit on the card
    at once (``per_sm`` on each of ``n_sm``), but no more than the most
    work items any routing of Tt tiles can give (Tt runs × ``n_cb`` column
    blocks). A function of shapes only, so a captured graph replays any
    routing."""
    return max(1, min(n_sm * max(1, per_sm), Tt * n_cb))


@functools.lru_cache(maxsize=None)
def _dense_occupancy(nmat: int, warps: int, stages: int, Tt: int,
                     index: int) -> int:
    from repro_torch.kernels import build
    with torch.cuda.device(index):
        n = build.library("ragged_dense_ffn").ragged_dense_occupancy(
            nmat, warps, stages, Tt)
    if n < 0:
        build.check(-n, "ragged_dense_occupancy")
    return n


def tensor_map_key(t: torch.Tensor, box) -> tuple:
    """What a TMA tensor map over ``t`` depends on: its device, address,
    shape and strides, and the box (the dtype is always bf16). A
    reallocated tensor gets a new map; a graph keeps the map it captured
    (the kernel takes it by value)."""
    return (t.device.index, t.data_ptr(), tuple(t.shape), tuple(t.stride()),
            tuple(box))


def tensor_map_geometry(t: torch.Tensor):
    """A tensor's dimensions innermost first and the byte strides of its
    outer dimensions, innermost first: the layout a tensor map takes."""
    dims = tuple(reversed(t.shape))
    strides = tuple(s * t.element_size() for s in reversed(t.stride()[:-1]))
    return dims, strides


def _tensor_map(t: torch.Tensor, box) -> ctypes.Array:
    """A cached tensor map over ``t`` with ``box`` (its 128-byte buffer).
    The caller holds it until its launch has copied it: a later call may
    clear the cache, and the buffer of a map dropped from it is freed (and
    its memory soon reused by the next map)."""
    key = tensor_map_key(t, box)
    m = _TMAPS.get(key)
    if m is None:
        from repro_torch.kernels import build
        if len(_TMAPS) >= _TMAP_CAP:
            _TMAPS.clear()
        dims, strides = tensor_map_geometry(t)
        m = (ctypes.c_ubyte * 128)()
        # Named, so the arrays outlive the call.
        c_dims = (ctypes.c_longlong * 3)(*dims)
        c_strides = (ctypes.c_longlong * 3)(*strides)
        c_box = (ctypes.c_int * 3)(*box)
        err = build.library("ragged_dense_ffn").ragged_dense_tensor_map(
            ctypes.addressof(m), t.data_ptr(), len(dims),
            ctypes.addressof(c_dims), ctypes.addressof(c_strides),
            ctypes.addressof(c_box))
        build.check(err, "ragged_dense_tensor_map")
        _TMAPS[key] = m
    return m


def ragged_dense_launch(name: str, x, tile_eid, n_tiles, weights, *,
                        grid: Optional[int] = None, cap: int = DENSE_NT,
                        warps: Optional[int] = None,
                        stages: Optional[int] = None) -> torch.Tensor:
    """Allocate, launch one all-hi kernel (``name``: gate/up with two
    weights, down with one), count. ``grid`` (CTAs; default
    ``dense_grid``), ``cap`` (most tiles per run), ``warps`` (consumer
    warps) and ``stages`` (ring slots; defaults ``DENSE_PLAN``) are there
    for the kernels' sweep in ``chip_smoke.py``."""
    from repro_torch.kernels import build
    dev = x.device
    Tt, K = tile_eid.shape[0], x.shape[1]
    E, N = weights[0].shape[0], weights[0].shape[2]
    out = torch.empty((x.shape[0], N), dtype=torch.bfloat16, device=dev)
    if Tt == 0:
        return out
    warps = DENSE_PLAN[name][0] if warps is None else warps
    stages = DENSE_PLAN[name][1] if stages is None else stages
    if grid is None:
        per_sm = _dense_occupancy(len(weights), warps, stages, Tt,
                                  dev.index)
        grid = dense_grid(_sm_count(dev.index), per_sm, Tt,
                          -(-N // (16 * warps)))
    # Held here until the launch returns: a map the cache drops while the
    # others are built would otherwise reach the kernel as freed memory.
    maps = [_tensor_map(x, DENSE_X_BOX)] + \
        [_tensor_map(w, DENSE_W_BOX) for w in weights]
    err = getattr(build.library("ragged_dense_ffn"), name)(
        *map(ctypes.addressof, maps), tile_eid.data_ptr(), n_tiles.data_ptr(),
        out.data_ptr(), Tt, K, N, E, grid, cap, stages, warps,
        _stream(dev.index))
    build.check(err, name)
    LAUNCHES[name] += 1
    return out


def ragged_dense_gateup(xs, tile_eid, n_tiles, w_gate, w_up, *,
                        bm: int) -> torch.Tensor:
    """The all-hi mode's gate/up: h (R, F) = bf16(silu(xs·W_gate[e])) ·
    bf16(xs·W_up[e]) per row tile, e = ``tile_eid[t]``, from (E, K, F) bf16
    banks. Rows of tiles ``t >= n_tiles`` are not written on the card;
    ``tile_eid`` may hold the live tiles' experts in any order (an
    expert's tiles need not be adjacent), each id in ``[0, E)``."""
    _no_grad_inputs("ragged_dense_gateup", xs, w_gate, w_up)
    _check_dense(xs, tile_eid, n_tiles, (w_gate, w_up), bm, "xs")
    if xs.device.type == "cpu":
        return ref.ragged_dense_gateup_ref(xs, tile_eid, w_gate, w_up, bm=bm)
    _card_only(xs.device, "ragged_dense_gateup")
    return _dense_call("ragged_dense_gateup", bm, xs, tile_eid, n_tiles,
                       (w_gate, w_up))


def ragged_dense_down(h, tile_eid, n_tiles, w_down, *,
                      bm: int) -> torch.Tensor:
    """The all-hi mode's down: y (R, D) = h · W_down[e] per row tile from
    an (E, F, D) bf16 bank."""
    _no_grad_inputs("ragged_dense_down", h, w_down)
    _check_dense(h, tile_eid, n_tiles, (w_down,), bm, "h")
    if h.device.type == "cpu":
        return ref.ragged_dense_down_ref(h, tile_eid, w_down, bm=bm)
    _card_only(h.device, "ragged_dense_down")
    return _dense_call("ragged_dense_down", bm, h, tile_eid, n_tiles,
                       (w_down,))


def ragged_dense_ffn(xs, tile_eid, n_tiles, bank: dict, *,
                     bm: int) -> torch.Tensor:
    """The ragged dense SwiGLU FFN (the two all-hi kernels in turn):
    ``bank`` {'w_gate', 'w_up', 'w_down'} → (E, K, N) bf16, every tile on
    its expert's weights. Returns (R, D)."""
    h = ragged_dense_gateup(xs, tile_eid, n_tiles, bank["w_gate"],
                            bank["w_up"], bm=bm)
    return ragged_dense_down(h, tile_eid, n_tiles, bank["w_down"], bm=bm)


def flash_decode_paged(q, k, v, table, valid) -> torch.Tensor:
    """q (B, H, hd); k/v (N, Hkv, bt, hd) block pools; table (B, nb) int32
    (-1 = unallocated, masked by ``valid``); valid (B, nb·bt) bool →
    (B, H, hd) bf16."""
    _no_grad_inputs("flash_decode_paged", q, k, v)
    dev = q.device
    _need(q, "q", torch.bfloat16, dev, 3)
    _need(k, "k", torch.bfloat16, dev, 4)
    _need(v, "v", torch.bfloat16, dev, 4)
    _need(table, "table", torch.int32, dev, 2)
    _need(valid, "valid", torch.bool, dev, 2)
    B, H, hd = q.shape
    N, Hkv, bt, hd_k = k.shape
    nb = table.shape[1]
    if v.shape != k.shape or hd_k != hd or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not form a GQA attention")
    if table.shape[0] != B or valid.shape != (B, nb * bt):
        raise ValueError(f"table {tuple(table.shape)} / valid "
                         f"{tuple(valid.shape)} != (B, nb) / (B, nb·bt)")
    if dev.type == "cpu":
        return ref.flash_decode_paged_ref(q, k, v, table, valid)
    _card_only(dev, "flash_decode_paged")
    key = ("flash_decode_paged", q.shape, k.shape, nb, dev.index)
    plan = _PLANS.get(key)
    if plan is None:
        if bt % 16 or bt * max(decode_width(hd), hd) > 8192:
            raise ValueError(f"the CUDA kernel takes bt a multiple of 16 "
                             f"with bt·hd <= 8192 at the compiled width (a "
                             f"block is 16-row MMA chunks, and one block of "
                             f"K and V per warp stage fits in shared "
                             f"memory); got bt={bt}, hd={hd}")
        plan = _new_plan(key, q, Hkv, nb, (B, H, Hkv, bt, hd, nb))
    return _decode_launch(plan, "flash_decode_paged", q, k, v, table, valid)


def _gemm_launch(library: str, name: str, x, packed, scales, E: int,
                 C: int, K: int, N: int, bits: int,
                 group: int) -> torch.Tensor:
    """Plan, allocate (the output; float32 partials when K is split),
    launch, count: the two GEMM wrappers' CUDA branch."""
    from repro_torch.kernels import build
    _gemm_shape_rules(K, N, group, x, packed, scales)
    dev = x.device
    plan = gemm_plan(E, C, K, N, group, _sm_count(dev.index))
    out = torch.empty((E, C, N), dtype=torch.bfloat16, device=dev)
    scratch = None if plan.n_split == 1 else torch.empty(
        (plan.n_split, E, C, N), dtype=torch.float32, device=dev)
    # The plain GEMM's entry takes M = C rows of one weight (no E).
    rows = (E, C) if library == "grouped_quant_matmul" else (C,)
    err = getattr(build.library(library), library)(
        x.data_ptr(), packed.data_ptr(), scales.data_ptr(), out.data_ptr(),
        _ptr(scratch), *rows, K, N, bits, group, plan.nt, plan.n_split,
        plan.gps, plan.gpc, _stream(dev.index))
    build.check(err, library)
    LAUNCHES[name] += 1
    return out


def grouped_lo_matmul(xg, packed, scales, bits: int,
                      group: int) -> torch.Tensor:
    """The grouped lo-tier GEMM of the padded MoE dispatch: xg (E, C, K)
    bf16 × codes (E, K//epb, N) / scales (E, K//g, N) → (E, C, N) bf16, by
    the group-blocked rule (float32 partial dot per scale group, the scale
    applied after). Any C. The CUDA branch takes group a multiple of 16,
    N a multiple of 64 and 16-byte aligned tensors (``_gemm_shape_rules``)."""
    _no_grad_inputs("grouped_lo_matmul", xg, scales)
    dev = xg.device
    _need(xg, "xg", torch.bfloat16, dev, 3)
    E, C, K = xg.shape
    N = _check_codes(packed, scales, K, bits, group, dev, 3)
    if packed.shape[0] != E:
        raise ValueError(f"packed {tuple(packed.shape)} holds another "
                         f"number of experts than xg (E={E})")
    if dev.type == "meta":
        return _priced("grouped_lo_matmul", (E, C, N), dev, 2 * E * C * K * N,
                       _nb(xg, packed, scales) + 2 * E * C * N)
    if dev.type == "cpu":
        return ref.grouped_lo_gemm(xg, packed, scales, bits, group)
    return _gemm_launch("grouped_quant_matmul", "grouped_lo_matmul", xg,
                        packed, scales, E, C, K, N, bits, group)


def quant_matmul_op(x, qt) -> torch.Tensor:
    """x (M, K) bf16 × one quantized weight ``qt`` (``QuantizedTensor``,
    codes (K//epb, N)) → (M, N) bf16. Any M. On the CPU the reference's
    ``quant_matmul`` rule (``ref.quant_matmul_ref``: the weight dequantized
    to float32, then a float32 product). On the card the grouped GEMM's
    kernel at E = 1 with the group-blocked rule (Σ_g s_g · (x_g · q_g),
    exact products, float32 sums): the two differ only at float32
    rounding. The CUDA branch has the grouped GEMM's limits."""
    _no_grad_inputs("quant_matmul", x, qt.scales)
    dev = x.device
    _need(x, "x", torch.bfloat16, dev, 2)
    M, K = x.shape
    bits, group = qt.bits, qt.group_size
    N = _check_codes(qt.packed, qt.scales, K, bits, group, dev, 2)
    if dev.type == "cpu":
        return ref.quant_matmul_ref(x, qt.packed, qt.scales, bits, group)
    _card_only(dev, "quant_matmul")
    return _gemm_launch("quant_matmul", "quant_matmul", x, qt.packed,
                        qt.scales, 1, M, K, N, bits, group).view(M, N)


def flash_decode(q, k, v, valid, lse: bool = False):
    """q (B, H, hd) contiguous; k/v (B, S, Hkv, hd) views with a contiguous
    last axis and equal strides (the dense cache's ``k.transpose(1, 2)``:
    no copy); valid (B, S) bool → (B, H, hd) bf16. Any S. ``lse``: also
    each head's natural log-sum-exp of its scaled, masked logits, (B, H)
    float32 (-inf for a row with no valid slot): returns (out, lse), out
    the same bits as without it. A cache whose slots are split over ranks
    combines the ranks' outputs by it."""
    _no_grad_inputs("flash_decode", q, k, v)
    dev = q.device
    _need(q, "q", torch.bfloat16, dev, 3)
    _need(k, "k", torch.bfloat16, dev, 4, contiguous=False)
    _need(v, "v", torch.bfloat16, dev, 4, contiguous=False)
    _need(valid, "valid", torch.bool, dev, 2)
    B, H, hd = q.shape
    _, S, Hkv, hd_k = k.shape
    if v.shape != k.shape or k.shape[0] != B or hd_k != hd or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not form a GQA attention")
    if valid.shape != (B, S):
        raise ValueError(f"valid {tuple(valid.shape)} != (B, S) = "
                         f"({B}, {S})")
    stride = k.stride()
    if stride[-1] != 1 or v.stride() != stride:
        raise ValueError(f"k/v strides {stride}/{v.stride()}: the last "
                         f"axis must be contiguous and both views alike")
    if dev.type == "meta":
        # QK and PV over every slot of every row: the rows' K/V read once.
        nbytes = _nb(q, valid) + 2 * B * S * Hkv * hd * k.element_size() + \
            2 * B * H * hd + (4 * B * H if lse else 0)
        flops = 4 * B * H * S * hd
        out = _priced("flash_decode", (B, H, hd), dev, flops, nbytes)
        return (out, torch.empty((B, H), dtype=torch.float32, device=dev)) \
            if lse else out
    if dev.type == "cpu":
        return ref.flash_decode_ref(q, k, v, valid, lse=lse)
    key = ("flash_decode", q.shape, k.shape, stride, dev.index)
    plan = _PLANS.get(key)
    if plan is None:
        st_b, st_s, st_h, _ = stride
        if st_b % 8 or st_s % 8 or st_h % 8:
            raise ValueError(f"k/v strides {stride}: the CUDA kernel copies "
                             f"rows in 16-byte chunks, so the batch, "
                             f"sequence and head strides must be multiples "
                             f"of 8")
        plan = _new_plan(key, q, Hkv, -(-S // DECODE_TILE),
                         (B, H, Hkv, S, hd, st_b, st_s, st_h))
    return _decode_launch(plan, "flash_decode", q, k, v, valid, lse=lse)
