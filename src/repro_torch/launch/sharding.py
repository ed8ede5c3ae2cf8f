"""Sharding planner of the port: param-tree paths → partition specs (the
reference's ``launch/sharding.py``, its rules and notes word for word),
and the process-per-rank half that GSPMD does for the reference: the
slice of a leaf, or of an expert bank, that one rank of a (data × model)
grid holds.

A spec is a tuple with one entry per leading dim of the leaf (trailing
dims unnamed): None (replicated), "model", a data axis name, or a tuple
of axis names — the reference's ``PartitionSpec`` without JAX, normalised
as it is (a one-axis tuple is that axis's name).

Baseline rules (§6 of DESIGN.md). Every rule degrades to replication rather
than failing, and the planner records *why* (the roofline §Perf loop reads
this to find sharding-limited architectures):

* embeddings (V, d)            → (model, None); lm_head (d, V) → (None, model)
* attention, heads divisible   → shard the head (q_dim) axis over model
* attention, heads NOT divisible → replicated projections and
  sequence-parallel attention
  (``models.layers._seq_parallel_constraint``)
* dense FFN                    → (None, model) / (model, None) classic TP
* MoE expert banks             → expert axis over model (expert parallelism);
  DynaExq hi pool + packed lo pool shard the same way; slot maps replicate
* Mamba in/out projections     → contraction-axis sharding (the concatenated
  zxBCdt output axis cannot be split without segment-aware reshards)
* batch dims of activations/caches → ('pod','data'); KV cache sequence axis
  → model (flash-decode style) so 32k-context decode fits HBM

``shard_tree`` cuts a whole tree (params, an expert bank, caches, inputs,
AdamW state) into one rank's shards by these specs, and ``rank_bytes``
prices a rank's shards from the specs alone: what the batch entry points
under a planner (``models.specs``) hold on each rank.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.ver import ExpertBankQ
from repro_torch.launch.dist import DistContext, shard_range
from repro_torch.models.config import ArchConfig
from repro_torch.quant.qtensor import QuantizedTensor


def _div(n: int, d: int) -> bool:
    return n % d == 0


def P(*entries) -> tuple:
    """A partition spec: ``entries`` as ``jax.sharding.PartitionSpec``
    keeps them (a one-axis tuple becomes that axis's name)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _flat(spec_entry):
    """Axis names in one spec entry (str | tuple | None)."""
    if spec_entry is None:
        return ()
    return (spec_entry,) if isinstance(spec_entry, str) else tuple(spec_entry)


@dataclasses.dataclass(frozen=True)
class GridShape:
    """The mesh a planner reads: axis sizes by name and the axis names in
    order (the two attributes of a ``jax.sharding.Mesh`` it uses); a
    context's grid is ``GridShape({"data": ctx.data_size, "model":
    ctx.model_size}, ("data", "model"))``."""
    shape: Dict[str, int]
    axis_names: Tuple[str, ...]


class ShardingPlanner:
    def __init__(self, cfg: ArchConfig, mesh,
                 notes: list | None = None, seq_shard_cache: bool = True,
                 pad_heads: bool = False, fsdp: bool = False):
        self.cfg = cfg
        self.mesh = mesh
        self.model_n = mesh.shape["model"]
        self.dp = tuple(a for a in mesh.axis_names if a != "model")
        self.dp_n = int(np.prod([mesh.shape[a] for a in self.dp]))
        self.notes = notes if notes is not None else []
        self.seq_shard_cache = seq_shard_cache
        self.pad_heads = pad_heads  # §Perf variant: uneven head sharding
        # FSDP (train): additionally shard params/optimizer over the data
        # axes on one divisible dim — 30B×(2+8)B of params+AdamW moments
        # cannot live 16-way-sharded on 16 GB chips.
        self.fsdp = fsdp

    # ---- leaves ---------------------------------------------------------
    def spec_for_param(self, path: str, shape: tuple) -> tuple:
        spec = self._base_param_spec(path, shape)
        if self.fsdp and shape:
            spec = self._add_fsdp(spec, shape)
        return spec

    def _add_fsdp(self, spec: tuple, shape: tuple) -> tuple:
        parts = list(spec) + [None] * (len(shape) - len(spec))
        best, best_dim = None, -1
        for i, (axis, dim) in enumerate(zip(parts, shape)):
            if axis is None and dim % self.dp_n == 0 and dim > best_dim:
                best, best_dim = i, dim
        if best is None:
            return spec
        parts[best] = self.dp if len(self.dp) > 1 else self.dp[0]
        return P(*parts)

    def _base_param_spec(self, path: str, shape: tuple) -> tuple:
        cfg, mn = self.cfg, self.model_n
        p = path.lower()
        nd = len(shape)

        def lead(spec_tail: tuple) -> tuple:
            """Prepend Nones for stacked (layer) leading dims."""
            return P(*((None,) * (nd - len(spec_tail)) + spec_tail))

        if "embed" in p:
            return P("model", None) if _div(shape[0], mn) else P()
        if "lm_head" in p:
            return P(None, "model") if _div(shape[1], mn) else P()
        if ("wq" in p or "wk" in p or "wv" in p or "wo" in p) and cfg.attn:
            a = cfg.attn
            heads = a.n_heads if ("wq" in p or "wo" in p) else a.n_kv_heads
            if _div(heads, mn) or (self.pad_heads and "cross" not in p):
                if "wo" in p:
                    return lead(("model", None))
                return lead((None, "model"))
            # non-divisible heads: replicate the projections (FSDP still
            # shards their storage over data) and let the model apply
            # sequence-parallel attention (layers._seq_parallel_constraint).
            self._note(f"{path}: {heads} heads % {mn} != 0 → replicated "
                       f"params + sequence-parallel attention")
            return lead(())
        if "experts" in p or (".lo" in p or ".hi" in p):
            # stacked expert banks: (L, E, K, N) / packed / scales / hi pool
            if nd >= 3 and _div(shape[1], mn):
                return P(None, "model", *(None,) * (nd - 2))
            self._note(f"{path}: expert dim {shape} not divisible → replicated")
            return lead(())
        if "slot" in p:
            return lead(())
        if "router" in p:
            return lead(())
        if "mlp" in p or "shared" in p:
            if "w_down" in p:
                return lead(("model", None)) if _div(shape[-2], mn) else lead(())
            return lead((None, "model")) if _div(shape[-1], mn) else lead(())
        if "in_proj" in p or "out_proj" in p:
            # contraction sharding (see module docstring)
            return lead(("model", None)) if _div(shape[-2], mn) else lead(())
        return lead(())  # norms, conv, A_log, biases, scalars

    def _batch_spec(self, batch: int):
        """Batch dims shard over data×model when divisible (serving: keeps
        attention fully batch-local — no seq/head resharding collectives),
        else data-only, else replicated."""
        full = self.dp + ("model",)
        if _div(batch, self.dp_n * self.model_n):
            return full
        if _div(batch, self.dp_n):
            return self.dp
        if _div(batch, self.mesh.shape[self.dp[-1]]):
            return self.dp[-1]
        return None

    def spec_for_cache(self, path: str, shape: tuple) -> tuple:
        """Caches are stacked (nsb, B, ...)."""
        p = path.lower()
        nd = len(shape)
        batch = shape[1] if nd > 1 else 1
        bspec = self._batch_spec(batch)
        if bspec is None and batch > 1:
            self._note(f"{path}: cache batch {batch} → replicated")
        if "cross" in p and nd == 5:
            # (nsb, B, Senc, Hkv, hd) — encoder cross-attn KV, seq-major.
            return P(None, bspec, None, None, None)
        if (".k" in p or ".v" in p) and nd == 5:
            # (nsb, B, Hkv, C, hd) — head-major decode cache; shard the
            # sequence axis (3) over model when the batch does not use it.
            seq = "model" if (self.seq_shard_cache and bspec is not None
                              and "model" not in _flat(bspec)
                              and _div(shape[3], self.model_n)) else None
            return P(None, bspec, None, seq, None)
        if "state" in p and nd == 5:   # (nsb, B, H, P, N)
            return P(None, bspec, None, None, None)
        if "conv" in p and nd == 4:    # (nsb, B, K, c)
            return P(None, bspec, None, None)
        return P(*((None,) * nd))

    def spec_for_input(self, name: str, shape: tuple) -> tuple:
        nd = len(shape)
        if nd == 0:
            return P()
        batch = shape[0]
        # Decode token vectors follow the cache's full batch split; 2-D token
        # grids (train/prefill) stay data-sharded for the MoE dispatch/loss.
        if nd == 1 and _div(batch, self.dp_n * self.model_n):
            return P(self.dp + ("model",))
        if _div(batch, self.dp_n):
            return P(self.dp, *(None,) * (nd - 1))
        # batch-1 long-context: replicate (baseline; §Perf shards seq)
        self._note(f"input {name}: batch {batch} % {self.dp_n} → replicated")
        return P(*(None,) * nd)

    def _note(self, msg: str) -> None:
        if msg not in self.notes:
            self.notes.append(msg)

    # ---- trees ----------------------------------------------------------
    def tree_specs(self, tree: Any, kind: str) -> Dict[str, tuple]:
        """kind: 'param' | 'cache' | 'input' → {path: spec} over the
        leaves of one of the port's trees, each path as the reference's
        ``jax.tree_util.keystr`` names the same leaf of its tree (see
        ``leaf_paths``)."""
        fn = {"param": self.spec_for_param, "cache": self.spec_for_cache,
              "input": self.spec_for_input}[kind]
        return {path: fn(path, tuple(leaf.shape))
                for path, leaf in leaf_paths(tree, kind == "cache")}


# ---- the port's trees, named as the reference's -------------------------
def leaf_paths(tree: Any, caches: bool = False
               ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, leaf) over the tensors of one of the port's trees, each path
    the reference's ``keystr`` of the same leaf in its own tree: dict keys
    as ``['key']``, the fields of a cache tuple, an ``ExpertBankQ`` and a
    ``QuantizedTensor`` as ``.field`` (a bank's leaves ``.lo.w_gate.packed``
    and ``.hi.w_gate``, as the reference's registered dataclasses print
    them). ``caches``: the port's {position: cache, CROSS: CrossKV} is the
    reference's ``DecodeCaches``: ``.blocks['0'].k``, ``.cross['k']``."""
    if caches:
        from repro_torch.models.model import CROSS
        for key, c in tree.items():
            if key == CROSS:
                for f in c._fields:
                    yield f".cross['{f}']", getattr(c, f)
            else:
                for f in c._fields:
                    yield f".blocks['{key}'].{f}", getattr(c, f)
        return
    yield from _walk(tree, "")


def _walk(node, prefix: str):
    if node is None:
        return
    if isinstance(node, torch.Tensor):
        yield prefix, node
    elif isinstance(node, ExpertBankQ):
        for name, q in node.lo.items():
            yield from _walk(q, f"{prefix}.lo.{name}")
        for name, h in node.hi.items():
            yield f"{prefix}.hi.{name}", h
        yield f"{prefix}.slot_owner", node.slot_owner
        yield f"{prefix}.slot_map", node.slot_map
    elif isinstance(node, QuantizedTensor):
        yield f"{prefix}.packed", node.packed
        yield f"{prefix}.scales", node.scales
    elif isinstance(node, dict):
        for k, v in node.items():
            yield from _walk(v, f"{prefix}['{k}']")
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        for f in node._fields:
            yield from _walk(getattr(node, f), f"{prefix}.{f}")
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _walk(v, f"{prefix}[{i}]")
    else:
        raise TypeError(f"{prefix}: no path rule for {type(node).__name__}")


# ---- what one rank holds ------------------------------------------------
def _axis_of(entry) -> Optional[str]:
    """The ``launch.dist`` axis one spec entry splits a dim over."""
    axes = _flat(entry)
    if not axes:
        return None
    if "model" in axes:
        return "model" if len(axes) == 1 else "tokens"
    return "data"


def local_shard(leaf: torch.Tensor, spec: tuple, ctx: DistContext
                ) -> torch.Tensor:
    """This rank's block of ``leaf`` under ``spec``: each named dim cut
    evenly over its axis ("model": the model index; data axes: the data
    index; both: the token index, data major), the rest whole. A copy
    (contiguous, on the leaf's device) where a dim was cut, the leaf
    itself otherwise."""
    out = leaf
    for dim, entry in enumerate(spec):
        axis = _axis_of(entry)
        if axis is None:
            continue
        sl = shard_range(leaf.shape[dim], ctx, axis)
        out = out.narrow(dim, sl.start, sl.stop - sl.start)
    return out if out is leaf else out.contiguous()


def bank_shard(bank, ctx: DistContext, ff: bool = False):
    """This rank's slice of an expert bank, stacked (L, E, ...) or one
    layer (E, ...): an ``ExpertBankQ`` (lo leaves and hi slots cut over the
    model axis: experts ``[j·E/N, (j+1)·E/N)``, slots ``[j·n_hi/N, ...)``;
    ``slot_owner``/``slot_map`` stay global) or a dense dict of (…, E, K,
    N) weights (experts over model). ``ff`` (the FF-sliced regime, which
    ``models.moe`` takes for tokens replicated over data): also the last
    dim over the data axis — gate/up's F columns ``[i·F/dp, ...)`` and
    down's D columns ``[i·D/dp, ...)``, codes and scales alike (codes pack
    along K, so no byte straddles a slice). Where the experts do not divide
    over the model axis, the whole bank (the reference's replicated
    fallback). Contiguous copies."""
    def cut(t, expert_dim):
        dims = {}
        if t.shape[expert_dim] % ctx.model_size == 0:
            dims[expert_dim] = "model"
        if ff:
            dims[t.ndim - 1] = "data"
        spec = tuple(dims.get(d) for d in range(t.ndim))
        return local_shard(t, spec, ctx).contiguous()

    if isinstance(bank, ExpertBankQ):
        e_dim = bank.lo["w_gate"].packed.ndim - 3
        E = bank.slot_map.shape[-1]
        if E % ctx.model_size:
            return bank
        lo = {}
        for n, q in bank.lo.items():
            packed, scales = cut(q.packed, e_dim), cut(q.scales, e_dim)
            shape = tuple(q.shape[:e_dim]) + (packed.shape[e_dim],) + \
                tuple(q.shape[e_dim + 1:-1]) + (packed.shape[-1],)
            lo[n] = QuantizedTensor(packed, scales, q.bits, q.group_size,
                                    shape)
        return ExpertBankQ(lo=lo, hi={n: cut(h, e_dim)
                                      for n, h in bank.hi.items()},
                           slot_owner=bank.slot_owner,
                           slot_map=bank.slot_map)
    e_dim = bank["w_gate"].ndim - 3
    if bank["w_gate"].shape[e_dim] % ctx.model_size:
        return bank
    return {n: cut(w, e_dim) for n, w in bank.items()}


# ---- a whole tree's shards ----------------------------------------------
def grid_of(ctx: DistContext) -> GridShape:
    """The mesh a planner reads for ``ctx``'s (data × model) grid."""
    return GridShape({"data": ctx.data_size, "model": ctx.model_size},
                     ("data", "model"))


def _spec_fn(planner: ShardingPlanner, kind: str):
    if kind not in ("param", "cache", "input"):
        raise ValueError(f"kind={kind!r}; one of param, cache, input "
                         f"(AdamW state is cut as params, the reference's "
                         f"rule)")
    return {"param": planner.spec_for_param, "cache": planner.spec_for_cache,
            "input": planner.spec_for_input}[kind]


def _bank_whole(bank: ExpertBankQ, n_model: int) -> bool:
    """``bank_shard``'s fallback: experts that do not divide over the model
    axis stay whole on every rank (hi pool included)."""
    return bank.slot_map.shape[-1] % n_model != 0


def _split_counts(spec: tuple, grid: GridShape) -> list:
    """How many ways each named dim of ``spec`` is cut on ``grid``."""
    out = []
    for entry in spec:
        n = 1
        for a in _flat(entry):
            n *= grid.shape[a] if a in grid.shape else \
                grid.shape["data"]           # ("pod", "data") → data
        out.append(n)
    return out


def shard_tree(tree: Any, kind: str, planner: ShardingPlanner,
               ctx: DistContext, microbatches: int = 1) -> Any:
    """This rank's shards of every leaf of ``tree`` under the planner's
    specs for ``kind`` ("param": params, an expert bank, or AdamW state
    {"m", "v", "step"}, as the reference cuts ``adamw_init``'s tree;
    "cache": the dense caches; "input": a dict of inputs, or one input
    tensor): the same structure, each leaf cut by ``local_shard`` (a data
    entry of ("pod", "data") is the context's one data axis). An
    ``ExpertBankQ`` is cut leaf by leaf by its specs, its ``QuantizedTensor``
    shapes updated; where its experts do not divide over the model axis it
    stays whole (``bank_shard``'s rule). Contiguous copies where a leaf is
    cut, the leaf itself where it is not. ``microbatches`` (inputs of a
    train step that accumulates over microbatches): the rows are that
    many global chunks in order, each cut by its own spec, and the rank's
    pieces stacked in order, so that the step's m-th cut of the rank's
    rows is its shard of global microbatch m (the reference reshapes the
    batch to (microbatches, B/microbatches) before it scans)."""
    fn = _spec_fn(planner, kind)
    if kind == "cache":
        from repro_torch.models.model import CROSS
        out = {}
        for key, c in tree.items():
            pre = ".cross" if key == CROSS else f".blocks['{key}']"
            fields = []
            for f in c._fields:
                t = getattr(c, f)
                path = f"{pre}['{f}']" if key == CROSS else f"{pre}.{f}"
                spec = fn(path, tuple(t.shape))
                _seq_cut(path, spec, t, planner)
                fields.append(local_shard(t, spec, ctx))
            out[key] = type(c)(*fields)
        return out
    return _shard(tree, "", fn, ctx,
                  microbatches if kind == "input" else 1)


def _seq_cut(path: str, spec: tuple, t: torch.Tensor,
             planner: ShardingPlanner) -> None:
    """A dense K/V cache whose rows split over data alone has its sequence
    cut over model (the planner's flash-decode rule); the planner keeps it
    whole where the capacity does not divide the model axis, and then a
    rank's local shapes no longer say which it got: refused here."""
    if (".k" in path or ".v" in path) and t.dim() == 5 and \
            planner.seq_shard_cache and planner.model_n > 1 and \
            spec[1] is not None and "model" not in _flat(spec[1]) and \
            spec[3] is None:
        raise ValueError(f"{path}: capacity {t.shape[3]} does not divide "
                         f"the model axis ({planner.model_n}); under the "
                         f"planner's specs the cache's sequence cuts over "
                         f"it")


def _rows_of_chunk(shape: tuple, nmb: int, path: str) -> tuple:
    """The shape of one of ``nmb`` chunks of an input's rows."""
    if not shape or nmb == 1:
        return shape
    if shape[0] % nmb:
        raise ValueError(f"input {path}: {shape[0]} rows do not cut into "
                         f"{nmb} microbatches")
    return (shape[0] // nmb,) + shape[1:]


def _shard(node, prefix: str, fn, ctx: DistContext, nmb: int = 1):
    if node is None:
        return None
    if isinstance(node, torch.Tensor):
        spec = fn(prefix, _rows_of_chunk(tuple(node.shape), nmb, prefix))
        if nmb == 1 or node.dim() == 0:
            return local_shard(node, spec, ctx)
        return torch.cat([local_shard(c, spec, ctx)
                          for c in node.chunk(nmb)])
    if isinstance(node, ExpertBankQ):
        if _bank_whole(node, ctx.model_size):
            return node
        lo = {}
        for name, q in node.lo.items():
            pre = f"{prefix}.lo.{name}"
            packed = local_shard(q.packed, fn(f"{pre}.packed",
                                              tuple(q.packed.shape)), ctx)
            scales = local_shard(q.scales, fn(f"{pre}.scales",
                                              tuple(q.scales.shape)), ctx)
            shape = tuple(q.shape[:-3]) + (packed.shape[-3],) + \
                tuple(q.shape[-2:-1]) + (packed.shape[-1],)
            lo[name] = QuantizedTensor(packed, scales, q.bits, q.group_size,
                                       shape)
        return ExpertBankQ(
            lo=lo, hi={n: _shard(h, f"{prefix}.hi.{n}", fn, ctx)
                       for n, h in node.hi.items()},
            slot_owner=_shard(node.slot_owner, f"{prefix}.slot_owner", fn,
                              ctx),
            slot_map=_shard(node.slot_map, f"{prefix}.slot_map", fn, ctx))
    if isinstance(node, dict):
        return {k: _shard(v, f"{prefix}['{k}']", fn, ctx, nmb)
                for k, v in node.items()}
    raise TypeError(f"{prefix}: no shard rule for {type(node).__name__}")


def rank_bytes(tree: Any, kind: str, planner: ShardingPlanner,
               grid: GridShape, microbatches: int = 1) -> int:
    """The bytes one rank's shards of ``tree`` (global shapes; abstract
    ``meta`` tensors will do) hold under the planner's specs for ``kind``
    (``shard_tree``'s kinds, rules and ``microbatches``), from the specs
    alone: each leaf's bytes over the product of the splits of its dims.
    Every rank of the grid holds the same (the cuts are even)."""
    fn = _spec_fn(planner, kind)
    total = 0
    whole = set()
    if kind != "cache":
        for path, bank in _banks(tree, ""):
            if _bank_whole(bank, grid.shape["model"]):
                whole.add(path)
    nmb = microbatches if kind == "input" else 1
    for path, leaf in leaf_paths(tree, kind == "cache"):
        size = leaf.numel() * leaf.element_size()
        if not any(path.startswith(w + ".") for w in whole):
            shape = _rows_of_chunk(tuple(leaf.shape), nmb, path)
            for n in _split_counts(fn(path, shape), grid):
                size //= n
        total += size
    return total


def _banks(node, prefix: str):
    if isinstance(node, ExpertBankQ):
        yield prefix, node
    elif isinstance(node, dict):
        for k, v in node.items():
            yield from _banks(v, f"{prefix}['{k}']")


def held_bytes(tree: Any, caches: bool = False) -> int:
    """The bytes of every tensor leaf of ``tree`` (a rank's shards;
    ``caches``: a dense caches dict, as ``leaf_paths`` takes it)."""
    return sum(t.numel() * t.element_size()
               for _, t in leaf_paths(tree, caches))


_KEY = re.compile(r"\['([^']*)'\]")


def param_specs(tree: Any, planner: ShardingPlanner) -> Dict:
    """The planner's param specs of ``tree`` (global shapes; ``meta``
    tensors will do) as a nested dict of the tree's own keys, a spec tuple
    at each leaf: what the model code reads beside a rank's params."""
    out: Dict = {}
    for path, spec in planner.tree_specs(tree, "param").items():
        keys = _KEY.findall(path)
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = spec
    return out
