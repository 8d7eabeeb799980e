"""Mixtral 8x7B [arXiv:2401.04088; hf]: 32L d=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, sliding-window attention (4096)."""
from repro_torch.models.config import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=32000,
    attn_window=4096, rope_theta=1e6,
    moe=MoEConfig(n_experts=8, top_k=2))

SMOKE = ModelConfig(
    name="mixtral-8x7b-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    attn_window=32, rope_theta=1e6,
    moe=MoEConfig(n_experts=4, top_k=2))
