"""Architecture registry of the port: ``get_config(name)`` returns the full
configuration, ``get_config(name, reduced=True)`` the 2-layer smoke
variant (the same reduction rule as the reference package)."""
from __future__ import annotations

from repro_torch.models.config import ArchConfig, AttnConfig, MoEConfig

_CONFIGS = {
    # Qwen3-30B-A3B: fine-grained MoE, 128 experts top-8, GQA kv=4.
    "qwen3-moe-30b-a3b": ArchConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        vocab_size=151936,
        d_ff=0,
        attn=AttnConfig(n_heads=32, n_kv_heads=4, head_dim=128,
                        rope_theta=1_000_000.0, qk_norm=True),
        moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768,
                      norm_topk_prob=True),
        norm_eps=1e-6,
        max_seq_len=131072,
        source="hf:Qwen/Qwen3-30B-A3B; paper Table 3",
    ),
    # Qwen3-Next-80B-A3B, the paper's flagship (Int4-hi / Int2-lo): 512
    # experts top-10 and one shared expert. Noted deviation, as in the
    # reference: the real model's gated-deltanet hybrid layers are
    # approximated by full attention.
    "qwen3-moe-80b-a3b": ArchConfig(
        name="qwen3-moe-80b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        vocab_size=151936,
        d_ff=0,
        attn=AttnConfig(n_heads=16, n_kv_heads=2, head_dim=256,
                        rope_theta=10_000_000.0, qk_norm=True),
        moe=MoEConfig(num_experts=512, top_k=10, d_ff_expert=512,
                      n_shared_experts=1, d_ff_shared=512,
                      norm_topk_prob=True),
        norm_eps=1e-6,
        max_seq_len=262144,
        source="paper Table 3; hf:Qwen/Qwen3-Next-80B-A3B",
    ),
    # IBM Granite-3.0-1B-A400M: small MoE, 32 experts top-8.
    "granite-moe-1b-a400m": ArchConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        n_layers=24,
        d_model=1024,
        vocab_size=49155,
        d_ff=0,
        attn=AttnConfig(n_heads=16, n_kv_heads=8, head_dim=64,
                        rope_theta=10000.0),
        moe=MoEConfig(num_experts=32, top_k=8, d_ff_expert=512,
                      norm_topk_prob=True),
        norm_eps=1e-6,
        tie_embeddings=True,
        max_seq_len=4096,
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    ),
}

ARCH_IDS = tuple(_CONFIGS)


def get_config(name: str, reduced: bool = False) -> ArchConfig:
    if name not in _CONFIGS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    cfg = _CONFIGS[name]
    return cfg.reduced() if reduced else cfg
