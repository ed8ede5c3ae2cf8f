"""The dry run: every (arch × input shape) on the production grids,
priced per rank without allocating (the reference's
``launch/dryrun.py``).

For one (arch × shape × grid) ``run_one`` builds the step the reference
lowers (``launch.shapes.build_dryrun``), cuts its abstract arguments into
one rank's shards by the planner's specs, and runs the rank's share of
the step (``models.specs``) on ``meta`` tensors under
``launch.dist.dry_run()``: every collective is recorded and moves
nothing, every kernel wrapper on the path prices its own work, and
nothing is allocated on the host or on a card. It records:

* per-rank bytes of each argument (params, bank, caches, inputs, AdamW
  state: what the rank's shards hold) — ``argument_size_in_bytes``;
* ``temp_size_in_bytes``: the peak of the step's live intermediates,
  tracked by a ``TorchDispatchMode`` over the storages its ops create (a
  storage is live from the op that makes it until its last reference,
  autograd's saved tensors included, dies); ``per_device_hbm_gb`` is
  arguments plus that peak, ``fits_80gb_hbm`` holds it to an H100 SXM
  80 GB (the reference's ``fits_16gb_hbm`` was a v5e figure);
* FLOPs (each op by ``torch.utils.flop_counter.FlopCounterMode``'s
  rules, its ``flop_registry``, plus the kernels' own) and bytes
  accessed (each op's operands as issued, ``roofline.op_bytes``: an
  unfused upper bound, as the reference's CPU HLO bytes are; plus the
  kernels' own), the dtype casts' bytes beside
  them (``convert_gb``); the kernels priced over every tile of their
  static tile map (a meta run sees no routing): an upper bound;
* ``sent_bytes``: ``SENT_BYTES`` by collective and axis, and
  ``collectives`` by collective (bytes SENT: the reference's are result
  shapes, see ``roofline.collective_bytes``);
* ``regimes``: the MoE layer's regimes (``models.moe.REGIMES``);
* ``roofline``: the terms on H100 data-sheet figures (``roofline.
  analyze``).

Ops are counted one by one as they run, so no loop body is undercounted
and nothing is extrapolated (the reference's ``extrapolate_s`` is gone).
Each cell runs for rank 0 and for the grid's last rank; their records
must agree, else both are written. ``hbm_gb_raw_cpu_hlo`` and the
roofline's ``hlo_gflops_per_chip`` keep the reference's names so that
the records line up; they hold the dispatched ops' bytes and FLOPs.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-moe-30b-a3b \
        --shape decode_32k
    python -m repro_torch.launch.dryrun --all --mesh both --out F.jsonl

It needs no card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.launch import dist as D
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import (HBM_BYTES, _tensors, analyze,
                                         collective_bytes, convert_bytes,
                                         op_bytes, tensor_bytes)
from repro_torch.launch.shapes import SHAPES, SKIPS, build_dryrun
from repro_torch.models import moe as MOE

#: The ten assigned archs, in the reference's order (its registry without
#: the 80B).
ASSIGNED = ("qwen3-moe-30b-a3b", "h2o-danube-3-4b", "granite-moe-1b-a400m",
            "llama3_2-3b", "whisper-tiny", "deepseek-7b", "jamba-v0_1-52b",
            "phi4-mini-3.8b", "mamba2-130m", "llava-next-34b")

#: Record keys that may differ between two ranks of one cell.
_PER_RANK = ("compile_s", "rank")


class StepRecorder(TorchDispatchMode):
    """What a step's dispatched ops compute (``flops``, by
    ``FlopCounterMode``'s rules: one mode instead of two halves the
    dispatch's cost), access (``op_bytes``), cast (``convert_bytes``), and
    the peak of the storages they create that are still referenced
    (``peak``), over ``meta`` tensors."""

    def __init__(self):
        super().__init__()
        self.flops = self.bytes = self.convert = 0
        self.live = self.peak = 0
        self._live = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func.overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        self.bytes += op_bytes(func, args, kwargs, out)
        self.convert += convert_bytes(func, args, kwargs, out)
        ins = {t.untyped_storage()._cdata for t in _tensors((args, kwargs))}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in ins or key in self._live:
                continue
            self._live[key] = st.nbytes()
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)
        return out

    def _free(self, key) -> None:
        self.live -= self._live.pop(key)


class OffMetaWatch(TorchDispatchMode):
    """The largest tensor any op under it creates off the ``meta`` device
    (the dry run allocates nothing: a guard)."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            if t.device.type != "meta":
                self.largest = max(self.largest,
                                   t.numel() * t.element_size())
        return out


def _rank_record(spec, r: int) -> dict:
    """Rank ``r``'s share of ``spec``'s step, recorded."""
    t0 = time.perf_counter()
    with D.dry_run() as dry:
        ctx, args, held = spec.rank(r)
        D.reset_sent()
        MOE.reset_regimes()
        with StepRecorder() as rec, D.dist_ctx(ctx):
            out = spec.step_fn(*args)
            out_b = sum(tensor_bytes(t) for t in _tensors(out))
            del out
        sent = {c: dict(v) for c, v in D.SENT_BYTES.items()}
        kernels = {k: dict(v) for k, v in dry.kernels.items()}
    regimes = {k: v for k, v in MOE.REGIMES.items() if v}
    costs = {"flops": rec.flops +
             sum(k["flops"] for k in kernels.values()),
             "bytes": rec.bytes + sum(k["bytes"] for k in kernels.values())}
    rl = analyze(costs, sent, spec.cfg, spec.kind, spec.tokens_per_step,
                 spec.grid)
    args_b = sum(held.values())
    notes = list(spec.notes)
    if kernels:
        notes.append("kernels priced over every tile of their static tile "
                     "map (a meta run sees no routing): an upper bound")
    return {
        "rank": r, "kind": spec.kind, "chips": spec.chips,
        "compile_s": round(time.perf_counter() - t0, 1),
        "roofline": rl.row(),
        "hbm_gb_raw_cpu_hlo": round(costs["bytes"] / 1e9, 3),
        "convert_gb": round(rec.convert / 1e9, 3),
        "collectives": rl.coll_detail,
        "sent_bytes": collective_bytes(sent),
        "regimes": regimes,
        "kernels": kernels,
        "notes": notes,
        "held_bytes": held,
        "temp_size_in_bytes": int(rec.peak),
        "argument_size_in_bytes": int(args_b),
        "output_size_in_bytes": int(out_b),
        "per_device_hbm_gb": round((args_b + rec.peak) / 1e9, 3),
        "fits_80gb_hbm": args_b + rec.peak <= HBM_BYTES,
    }


def run_one(arch: str, shape: str, multi_pod: bool, planner_kw=None,
            verbose: bool = True, microbatches: int = 1,
            nsb: Optional[int] = None) -> list:
    """The records of one cell: one where rank 0 and the grid's last rank
    agree (``"ranks"`` both), else one per rank. ``nsb``: cut the stack to
    that many super-blocks (``build_dryrun``'s ``nsb_override``; quick
    checks)."""
    grid = make_production_mesh(multi_pod=multi_pod)
    mesh = "2x16x16" if multi_pod else "16x16"
    with OffMetaWatch() as watch, D.dry_run():
        spec = build_dryrun(arch, shape, grid, planner_kw=planner_kw,
                            nsb_override=nsb, microbatches=microbatches)
        recs = [_rank_record(spec, r) for r in (0, spec.chips - 1)]
    head = {"arch": arch, "shape": shape, "mesh": mesh}
    for rec in recs:
        rec["largest_off_meta_bytes"] = watch.largest
    same = all({k: v for k, v in a.items() if k not in _PER_RANK} ==
               {k: v for k, v in recs[0].items() if k not in _PER_RANK}
               for a in recs)
    if same:
        rec = dict(head, ranks=[r["rank"] for r in recs],
                   **{k: v for k, v in recs[0].items() if k != "rank"})
        out = [rec]
    else:
        out = [dict(head, **r, ranks_differ=True) for r in recs]
    if verbose:
        for rec in out:
            print(json.dumps(rec, indent=2))
    return out


def main(argv=None) -> list:
    """The command line; returns every record written (the module exits
    1 when any cell failed)."""
    ap = argparse.ArgumentParser(
        description="Price every (arch × shape) per rank on the production "
                    "grids, over meta tensors; no card needed.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true",
                    help="all assigned (arch × shape) pairs")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--seq-shard-cache", type=int, default=1)
    ap.add_argument("--pad-heads", type=int, default=0,
                    help="shard non-divisible head counts")
    ap.add_argument("--microbatches", type=int, default=1)
    args = ap.parse_args(argv)

    planner_kw = dict(seq_shard_cache=bool(args.seq_shard_cache),
                      pad_heads=bool(args.pad_heads))
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        pairs = [(a, s) for a in ASSIGNED for s in SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        pairs = [(args.arch, args.shape)]

    ok = fail = skip = 0
    records = []
    t_all = time.perf_counter()
    for arch, shape in pairs:
        for multi in meshes:
            mesh = "2x16x16" if multi else "16x16"
            tag = f"{arch}×{shape}×{mesh}"
            if (arch, shape) in SKIPS:
                print(f"SKIP {tag}: {SKIPS[(arch, shape)]}")
                recs = [{"arch": arch, "shape": shape, "mesh": mesh,
                         "skipped": SKIPS[(arch, shape)]}]
                skip += 1
            else:
                try:
                    recs = run_one(arch, shape, multi, planner_kw,
                                   verbose=not args.all,
                                   microbatches=args.microbatches)
                    ok += 1
                    rec = recs[0]
                    rl = rec["roofline"]
                    print(f"OK   {tag}  compile {rec['compile_s']}s  "
                          f"bottleneck={rl['bottleneck']}  "
                          f"hbm/dev={rec['per_device_hbm_gb']}GB  "
                          f"useful={rl['useful_flops_ratio']}"
                          + ("  RANKS DIFFER" if len(recs) > 1 else ""))
                except Exception as e:  # noqa: BLE001 — record, go on
                    fail += 1
                    recs = [{"arch": arch, "shape": shape, "mesh": mesh,
                             "error": f"{type(e).__name__}: {e}"}]
                    print(f"FAIL {tag}: {type(e).__name__}: {e}")
                    if not args.all:
                        traceback.print_exc()
            records += recs
            if args.out:
                with open(args.out, "a") as f:
                    for rec in recs:
                        f.write(json.dumps(rec) + "\n")
    print(f"\ndone: {ok} ok, {fail} failed, {skip} skipped in "
          f"{time.perf_counter() - t_all:.1f} s")
    return records


if __name__ == "__main__":
    sys.exit(1 if any("error" in r for r in main()) else 0)
