"""Mixtral 8x22B [arXiv:2401.04088; hf]: 56L d=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, sliding-window attention (4096)."""
from repro_torch.models.config import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="mixtral-8x22b", family="moe", n_layers=56, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=16384, vocab=32768,
    attn_window=4096, rope_theta=1e6,
    moe=MoEConfig(n_experts=8, top_k=2))

SMOKE = ModelConfig(
    name="mixtral-8x22b-smoke", family="moe", n_layers=2, d_model=96,
    n_heads=6, n_kv_heads=2, d_ff=160, vocab=512,
    attn_window=32, rope_theta=1e6,
    moe=MoEConfig(n_experts=4, top_k=2))
