"""The dry run's input shapes and the step each (arch × shape) runs (the
reference's ``launch/shapes.py``).

``build_dryrun`` assembles, for one (arch × shape × grid): the step
function (the train step, ``prefill`` or ``decode_step`` of
``models.specs``), its abstract arguments as ``meta`` tensors of their
global shapes (nothing allocated), which kind of tree each is for the
sharding planner, and the planner itself. ``DryrunSpec.rank`` cuts the
arguments into one rank's shards and gives its context; ``launch.dryrun``
runs the rank's share of the step on them under ``launch.dist.dry_run()``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.core.ver import build_bank_empty
from repro_torch.launch import sharding as SH
from repro_torch.launch.dist import DistContext
from repro_torch.launch.mesh import dry_context
from repro_torch.models import specs as SP
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import init_caches, init_params
from repro_torch.training.adamw import adamw_init
from repro_torch.training.train import TrainConfig, make_train_step

SHAPES: Dict[str, Dict[str, Any]] = {
    "train_4k":    dict(kind="train",   seq=4096,    batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768,   batch=32),
    "decode_32k":  dict(kind="decode",  seq=32768,   batch=128),
    "long_500k":   dict(kind="decode",  seq=524288,  batch=1, long=True),
}

LONG_SWA_WINDOW = 8192

# whisper-tiny: enc-dec ASR with a 448-token decoder context — 500k-token
# decode is meaningless for the family.
SKIPS = {("whisper-tiny", "long_500k"): "enc-dec ASR: no 500k decode context"}

META = torch.device("meta")


def arch_for_shape(arch: str, shape: str) -> ArchConfig:
    """Shape-specific config variant: long_500k forces sub-quadratic
    attention (SWA window 8192) on full-attention archs."""
    cfg = get_config(arch)
    if SHAPES[shape].get("long") and cfg.attn is not None \
            and cfg.attn.sliding_window is None:
        cfg = dataclasses.replace(
            cfg, attn=dataclasses.replace(cfg.attn,
                                          sliding_window=LONG_SWA_WINDOW))
    return cfg


def _token_inputs(cfg: ArchConfig, batch: int, seq: int) -> Dict[str, Any]:
    """The batch's abstract inputs: int32 tokens (and the stub frontends'
    bf16 embeddings of a VLM or an encoder-decoder), ``meta`` tensors."""
    out: Dict[str, Any] = {}
    text = seq
    if cfg.family == "vlm":
        text = seq - cfg.num_image_tokens
        out["image_embeds"] = torch.empty(
            (batch, cfg.num_image_tokens, cfg.d_model), dtype=torch.bfloat16,
            device=META)
    if cfg.is_encoder_decoder:
        out["audio_embeds"] = torch.empty(
            (batch, cfg.encoder_seq, cfg.d_model), dtype=torch.bfloat16,
            device=META)
    out["tokens"] = torch.empty((batch, text), dtype=torch.int32, device=META)
    return out


@dataclasses.dataclass
class DryrunSpec:
    """One (arch × shape × grid): ``step_fn(*args)`` is the step on one
    rank's shards (run it under ``launch.dist.dist_ctx`` of that rank's
    context); ``args`` its global abstract arguments (``meta``), ``kinds``
    the planner's kind of each ("param", "cache", "input"), ``names``
    what the record calls each."""
    name: str
    step_fn: Callable
    args: tuple
    kinds: tuple
    names: tuple
    planner: SH.ShardingPlanner
    grid: SH.GridShape
    batch: int
    tokens_dp_sharded: bool
    microbatches: int
    cfg: ArchConfig
    kind: str
    tokens_per_step: int
    notes: list

    @property
    def chips(self) -> int:
        n = 1
        for v in self.grid.shape.values():
            n *= v
        return n

    def rank(self, r: int) -> Tuple[DistContext, tuple, Dict[str, int]]:
        """Rank ``r``'s context, its shards of ``args`` and the bytes of
        each argument it holds (by ``names``). Inside
        ``launch.dist.dry_run()``."""
        ctx = dry_context(self.grid, r, tokens_ep_sharded=False,
                          tokens_dp_sharded=self.tokens_dp_sharded,
                          planner=self.planner, batch=self.batch)
        local, held = [], {}
        for a, kind, name in zip(self.args, self.kinds, self.names):
            if a is None:
                local.append(None)
                continue
            cut = SH.shard_tree(a, kind, self.planner, ctx,
                                microbatches=self.microbatches
                                if kind == "input" else 1)
            local.append(cut)
            held[name] = SH.held_bytes(cut, caches=kind == "cache")
        return ctx, tuple(local), held


def _abstract_bank(cfg: ArchConfig, n_hi: int, lo_bits: int) -> Any:
    """One MoE position's stacked bank, abstract: the reference's
    ``build_bank`` under ``eval_shape`` (lo codes and scales at group 64,
    an empty bf16 hi pool of ``n_hi`` slots, the slot maps)."""
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    nsb = cfg.n_superblocks()
    shapes = {"w_gate": (nsb, E, d, f), "w_up": (nsb, E, d, f),
              "w_down": (nsb, E, f, d)}
    return build_bank_empty(shapes, n_hi=n_hi, lo_bits=lo_bits,
                            device=META)


def build_dryrun(arch: str, shape: str, grid: SH.GridShape, *,
                 lo_bits: int = 4, n_hi: Optional[int] = None,
                 planner_kw: Optional[dict] = None,
                 capacity_factor: float = 1.25,
                 nsb_override: Optional[int] = None,
                 microbatches: int = 1) -> DryrunSpec:
    """The reference's ``build_dryrun`` on the port: its planner (FSDP for
    train), its context (data axes, ``tokens_dp_sharded = batch % dp_n ==
    0``, the MoE layer's padded regimes), its capacities (prefill
    ``capacity_factor``, decode 2.0) and its step arguments. Inside
    ``launch.dist.dry_run()`` (the caches are drawn on ``meta``).
    ``nsb_override``: reduce the stack to N super-blocks (quick checks;
    the dry run counts every op as it runs, so no loop needs
    extrapolating)."""
    if (arch, shape) in SKIPS:
        raise ValueError(f"skip {arch}×{shape}: {SKIPS[(arch, shape)]}")
    info = SHAPES[shape]
    cfg = arch_for_shape(arch, shape)
    if nsb_override is not None:
        sb_len = len(cfg.superblock_or_default())
        cfg = dataclasses.replace(
            cfg, n_layers=sb_len * nsb_override,
            n_encoder_layers=min(cfg.n_encoder_layers, nsb_override)
            if cfg.is_encoder_decoder else 0)
    notes: list = []
    pkw = dict(planner_kw or {})
    if info["kind"] == "train":
        pkw.setdefault("fsdp", True)
    planner = SH.ShardingPlanner(cfg, grid, notes=notes, **pkw)
    SP.param_specs(cfg, planner)        # cached: the steps read, not make
    batch, seq = info["batch"], info["seq"]
    common = dict(planner=planner, grid=grid, batch=batch,
                  tokens_dp_sharded=batch % planner.dp_n == 0,
                  microbatches=1, cfg=cfg, kind=info["kind"], notes=notes,
                  name=f"{arch}×{shape}")
    params = init_params(cfg, device=META)

    if info["kind"] == "train":
        tcfg = TrainConfig(capacity_factor=capacity_factor,
                           microbatches=microbatches)
        step = make_train_step(cfg, tcfg)
        batch_abs = _token_inputs(cfg, batch, seq)
        batch_abs["labels"] = torch.empty(batch_abs["tokens"].shape,
                                          dtype=torch.int32, device=META)

        def train_step(params, opt_state, b):
            # The port's steps index with int64 ids (the launcher's
            # ``to_batch``); the reference's int32 inputs are cast here.
            return step(params, opt_state, {k: v.long() if not
                                            v.is_floating_point() else v
                                            for k, v in b.items()})

        return DryrunSpec(step_fn=train_step,
                          args=(params, adamw_init(params), batch_abs),
                          kinds=("param", "param", "input"),
                          names=("params", "adamw", "inputs"),
                          tokens_per_step=batch * seq,
                          **dict(common, microbatches=microbatches))

    # ---- serving shapes -------------------------------------------------
    bank = None
    if cfg.is_moe:
        bank = {}
        for pos, _ in enumerate(cfg.superblock_or_default()):
            if cfg.ffn_kind(pos) != "moe":
                continue
            E = cfg.moe.num_experts
            # Per-shard budget: each model rank owns E/16 experts and an
            # integer number of hi slots (the reference's rule).
            mn = grid.shape["model"]
            nh = n_hi if n_hi is not None else min(E, max(mn, E // 8))
            bank[str(pos)] = _abstract_bank(cfg, nh, lo_bits)
        # Serving never carries the dense experts: the bank serves them.
        params = _strip_experts(params, cfg)
    caches = init_caches(cfg, batch, seq, device=META)

    if info["kind"] == "prefill":
        def prefill_step(params, bank, b, caches):
            # Every row full (a VLM's prefix counted): the reference's
            # prefill takes no lengths.
            lay = SP.layout(SP.active())
            lengths = torch.full((lay.own.stop - lay.own.start,), seq,
                                 dtype=torch.int32, device=META)
            with torch.no_grad():
                return SP.prefill(params, cfg, b["tokens"], caches, lengths,
                                  bank=bank, capacity_factor=capacity_factor,
                                  image_embeds=b.get("image_embeds"),
                                  audio_embeds=b.get("audio_embeds"))

        return DryrunSpec(step_fn=prefill_step,
                          args=(params, bank, _token_inputs(cfg, batch, seq),
                                caches),
                          kinds=("param", "param", "input", "cache"),
                          names=("params", "bank", "inputs", "caches"),
                          tokens_per_step=batch * seq, **common)

    def serve_step(params, bank, token, pos, caches):
        with torch.no_grad():
            return SP.decode_step(params, cfg, token, pos, caches, bank=bank,
                                  capacity_factor=2.0)

    token = torch.empty((batch,), dtype=torch.int32, device=META)
    pos = torch.empty((), dtype=torch.int32, device=META)
    return DryrunSpec(step_fn=serve_step,
                      args=(params, bank, token, pos, caches),
                      kinds=("param", "param", "input", "input", "cache"),
                      names=("params", "bank", "token", "pos", "caches"),
                      tokens_per_step=batch, **common)


def _strip_experts(params, cfg: ArchConfig):
    sb = cfg.superblock_or_default()
    for pos, _ in enumerate(sb):
        if cfg.ffn_kind(pos) == "moe":
            params["blocks"][str(pos)]["moe"]["experts"] = None
    return params
