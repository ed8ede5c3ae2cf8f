"""Architecture registry of the port: ``get_config(name)`` returns the full
configuration, ``get_config(name, reduced=True)`` the smoke variant (2
layers, or one whole super-block of a hybrid stack: the same reduction
rule as the reference package). It holds every configuration of the
reference's registry: MoE, hybrid, dense and pure-SSM stacks, the
encoder-decoder audio stack (Whisper-tiny) and the VLM language backbone
(LLaVA-NeXT-34B)."""
from __future__ import annotations

from repro_torch.models.config import (ArchConfig, AttnConfig, MoEConfig,
                                       SSMConfig)

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
    # Jamba-v0.1-52B: hybrid 7:1 Mamba/attention super-blocks of 8, MoE
    # (16 experts top-2) on the odd positions, dense SwiGLU on the even
    # ones; no positional encoding on attention, an 8192 sliding window
    # (the reference's choice for long-context decode).
    "jamba-v0_1-52b": ArchConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        n_layers=32,
        d_model=4096,
        vocab_size=65536,
        d_ff=14336,
        attn=AttnConfig(n_heads=32, n_kv_heads=8, head_dim=128,
                        rope_theta=10000.0, sliding_window=8192,
                        use_rope=False),
        moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336,
                      norm_topk_prob=False),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk=64),
        superblock=("mamba", "mamba", "mamba", "mamba",
                    "mamba", "mamba", "mamba", "attn"),
        moe_positions=(1, 3, 5, 7),
        norm_eps=1e-6,
        max_seq_len=524288,
        source="arXiv:2403.19887 (Jamba). Note: Jamba uses no positional "
               "encoding on its attention layers (use_rope=False); we add "
               "an 8192 sliding window for the long_500k shape.",
    ),
    # Llama-3.2-3B: small llama3 dense decoder, GQA 24/8.
    "llama3_2-3b": ArchConfig(
        name="llama3.2-3b",
        family="dense",
        n_layers=28,
        d_model=3072,
        vocab_size=128256,
        d_ff=8192,
        attn=AttnConfig(n_heads=24, n_kv_heads=8, head_dim=128,
                        rope_theta=500000.0),
        norm_eps=1e-5,
        max_seq_len=131072,
        source="hf:meta-llama/Llama-3.2-1B family",
    ),
    # DeepSeek-LLM-7B: llama-architecture dense model, MHA (kv = 32).
    "deepseek-7b": ArchConfig(
        name="deepseek-7b",
        family="dense",
        n_layers=30,
        d_model=4096,
        vocab_size=102400,
        d_ff=11008,
        attn=AttnConfig(n_heads=32, n_kv_heads=32, head_dim=128,
                        rope_theta=10000.0),
        norm_eps=1e-6,
        max_seq_len=4096,
        source="arXiv:2401.02954 (DeepSeek LLM)",
    ),
    # Phi-4-mini-3.8B: dense decoder, RoPE + SwiGLU + GQA 24/8.
    "phi4-mini-3.8b": ArchConfig(
        name="phi4-mini-3.8b",
        family="dense",
        n_layers=32,
        d_model=3072,
        vocab_size=200064,
        d_ff=8192,
        attn=AttnConfig(n_heads=24, n_kv_heads=8, head_dim=128,
                        rope_theta=10000.0),
        norm_eps=1e-5,
        max_seq_len=131072,
        source="arXiv:2412.08905 (Phi-4)",
    ),
    # H2O-Danube3-4B: dense llama+mistral mix, head width 120, a 4096
    # sliding window.
    "h2o-danube-3-4b": ArchConfig(
        name="h2o-danube-3-4b",
        family="dense",
        n_layers=24,
        d_model=3840,
        vocab_size=32000,
        d_ff=10240,
        attn=AttnConfig(n_heads=32, n_kv_heads=8, head_dim=120,
                        rope_theta=10000.0, sliding_window=4096),
        norm_eps=1e-5,
        max_seq_len=524288,
        source="arXiv:2401.16818 (H2O-Danube); SWA per model card",
    ),
    # Mamba2-130m: attention-free SSD stack, no FFN, tied embeddings.
    "mamba2-130m": ArchConfig(
        name="mamba2-130m",
        family="ssm",
        n_layers=24,
        d_model=768,
        vocab_size=50280,
        d_ff=0,
        attn=None,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk=64),
        tie_embeddings=True,
        norm_eps=1e-5,
        max_seq_len=1048576,
        source="arXiv:2405.21060 (Mamba-2 / SSD)",
    ),
    # Whisper-tiny: encoder-decoder ASR backbone; the conv/mel frontend is a
    # stub (``models.frontend``: precomputed frame embeddings). Deviation
    # kept from the reference: positions use RoPE instead of Whisper's
    # learned embeddings, to stay shape-generic.
    "whisper-tiny": ArchConfig(
        name="whisper-tiny",
        family="audio",
        n_layers=4,               # decoder layers
        d_model=384,
        vocab_size=51865,
        d_ff=1536,
        attn=AttnConfig(n_heads=6, n_kv_heads=6, head_dim=64,
                        rope_theta=10000.0),
        is_encoder_decoder=True,
        n_encoder_layers=4,
        encoder_seq=1500,         # 30 s of audio at 50 Hz after the conv stub
        norm_eps=1e-5,
        max_seq_len=448,
        source="arXiv:2212.04356 (Whisper)",
    ),
    # LLaVA-NeXT-34B: VLM language backbone; the anyres-tiling ViT frontend
    # is a stub (``models.frontend``: precomputed patch embeddings).
    "llava-next-34b": ArchConfig(
        name="llava-next-34b",
        family="vlm",
        n_layers=60,
        d_model=7168,
        vocab_size=64000,
        d_ff=20480,
        attn=AttnConfig(n_heads=56, n_kv_heads=8, head_dim=128,
                        rope_theta=5000000.0),
        num_image_tokens=576,     # one anyres base tile (24x24 patches)
        norm_eps=1e-5,
        max_seq_len=131072,
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf (scaled to the 34B "
               "backbone)",
    ),
}

#: Other spellings of registered names.
_ALIASES = {"jamba-v0.1-52b": "jamba-v0_1-52b",
            "llama3.2-3b": "llama3_2-3b",
            "phi4-mini-3_8b": "phi4-mini-3.8b"}

ARCH_IDS = tuple(_CONFIGS)


def get_config(name: str, reduced: bool = False) -> ArchConfig:
    name = _ALIASES.get(name, name)
    if name not in _CONFIGS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    cfg = _CONFIGS[name]
    return cfg.reduced() if reduced else cfg
