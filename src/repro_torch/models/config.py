"""Architecture configuration (the port's copy of the reference dataclasses)
for every family this package serves: attention + MoE stacks, hybrid
Mamba/attention MoE stacks, dense attention stacks, pure Mamba-2 stacks,
the encoder-decoder audio stack and the VLM language backbone."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None   # None = full causal
    use_rope: bool = True
    qk_norm: bool = False                  # per-head RMSNorm on q/k

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    d_ff_shared: int = 0
    router_aux_coef: float = 0.01
    capacity_factor: float = 2.0
    norm_topk_prob: bool = True


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) layer: state width, conv taps, expansion, head width,
    B/C groups and the chunk of the chunked scan."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 64

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    # "moe", "hybrid", "dense", "ssm", "audio" or "vlm"
    family: str
    n_layers: int
    d_model: int
    vocab_size: int
    d_ff: int = 0
    attn: Optional[AttnConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # Hybrid stacks: per-position block kinds of one repeating super-block
    # ("attn" or "mamba"), MoE FFNs at ``moe_positions``, dense elsewhere.
    superblock: Tuple[str, ...] = ()
    moe_positions: Tuple[int, ...] = ()
    # Encoder-decoder (audio): encoder depth and the stub frontend's frames.
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 0
    # VLM: image embeddings (the stub frontend's patches) per request.
    num_image_tokens: int = 0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    max_seq_len: int = 131072
    source: str = ""

    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    def superblock_or_default(self) -> Tuple[str, ...]:
        """Layer-kind pattern of one repeating super-block."""
        if self.superblock:
            return self.superblock
        if self.family == "ssm":
            return ("mamba",)
        return ("attn",)

    def n_superblocks(self) -> int:
        sb = self.superblock_or_default()
        if self.n_layers % len(sb):
            raise ValueError(f"{self.name}: n_layers={self.n_layers} not a "
                             f"multiple of super-block {len(sb)}")
        return self.n_layers // len(sb)

    def ffn_kind(self, pos_in_superblock: int) -> str:
        if self.moe is None:
            return "dense"
        if not self.moe_positions:
            return "moe"
        return "moe" if pos_in_superblock in self.moe_positions else "dense"

    # ---- parameter accounting (the roofline's 2·N·D terms) ------------
    def param_count(self) -> int:
        return _count_params(self, active_only=False)

    def active_param_count(self) -> int:
        return _count_params(self, active_only=True)

    def reduced(self, n_layers: int = 2, d_model: int = 256,
                num_experts: int = 4, vocab: int = 512,
                max_seq_len: int = 1024) -> "ArchConfig":
        """Smoke-test variant of the same family (the reference's rule)."""
        d_model = min(d_model, 512)
        attn = self.attn
        if attn is not None:
            n_heads = max(2, min(attn.n_heads, 4))
            n_kv = max(1, min(attn.n_kv_heads, n_heads))
            attn = dataclasses.replace(
                attn, n_heads=n_heads, n_kv_heads=n_kv,
                head_dim=min(attn.head_dim, 64),
                sliding_window=(64 if attn.sliding_window else None))
        moe = self.moe
        if moe is not None:
            moe = dataclasses.replace(
                moe, num_experts=min(moe.num_experts, num_experts),
                top_k=min(moe.top_k, 2),
                d_ff_expert=min(moe.d_ff_expert, 2 * d_model),
                d_ff_shared=min(moe.d_ff_shared, d_model)
                if moe.n_shared_experts else 0)
        ssm = self.ssm
        if ssm is not None:
            ssm = dataclasses.replace(ssm, d_state=min(ssm.d_state, 32),
                                      head_dim=32, chunk=16)
        # A super-block stack keeps at least one whole super-block.
        sb = self.superblock_or_default()
        n_layers = max(n_layers, len(sb)) if self.superblock else n_layers
        if self.superblock and n_layers % len(sb):
            n_layers = len(sb)
        return dataclasses.replace(
            self, name=self.name + "-smoke", n_layers=n_layers,
            d_model=d_model, vocab_size=vocab,
            d_ff=min(self.d_ff, 2 * d_model) if self.d_ff else 0,
            attn=attn, moe=moe, ssm=ssm,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 64) if self.encoder_seq else 0,
            num_image_tokens=min(self.num_image_tokens, 16)
            if self.num_image_tokens else 0,
            max_seq_len=max_seq_len)


def _count_params(cfg: ArchConfig, active_only: bool) -> int:
    """The reference's count for the decoder-only stacks: embedding (and
    LM head unless tied), per layer the two pre-norms, the attention
    projections or the Mamba layer's (in/out projections, conv, A/D/dt,
    gate norm), then the router, every expert (``active_only``: top-k of
    them) and the shared experts, or the dense FFN; an encoder-decoder
    stack adds its encoder layers and each decoder layer's cross-attention.
    As in the reference, an encoder layer's MLP is priced at 3·d·d_ff
    though its GELU MLP holds two matrices."""
    d = cfg.d_model
    total = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    per_sb = 0
    for pos, kind in enumerate(cfg.superblock_or_default()):
        per_sb += 2 * d
        if kind == "attn" and cfg.attn is not None:
            a = cfg.attn
            per_sb += d * a.q_dim + 2 * d * a.kv_dim + a.q_dim * d
        elif kind == "mamba" and cfg.ssm is not None:
            s = cfg.ssm
            di, nh = s.d_inner(d), s.n_heads(d)
            conv_dim = di + 2 * s.n_groups * s.d_state
            per_sb += d * (2 * di + 2 * s.n_groups * s.d_state + nh)
            per_sb += conv_dim * s.d_conv + 3 * nh + di
            per_sb += di * d
        if cfg.ffn_kind(pos) == "moe":
            m = cfg.moe
            per_sb += d * m.num_experts
            e = m.num_experts if not active_only else m.top_k
            per_sb += e * 3 * d * m.d_ff_expert
            if m.n_shared_experts:
                per_sb += m.n_shared_experts * 3 * d * m.d_ff_shared
        elif cfg.d_ff:
            per_sb += 3 * d * cfg.d_ff
    total += per_sb * cfg.n_superblocks()
    if cfg.is_encoder_decoder and cfg.attn is not None:
        a = cfg.attn
        proj = d * a.q_dim + 2 * d * a.kv_dim + a.q_dim * d
        enc_layer = 2 * d + proj + 3 * d * cfg.d_ff
        total += cfg.n_encoder_layers * enc_layer + cfg.n_layers * (proj + d)
    return int(total)
