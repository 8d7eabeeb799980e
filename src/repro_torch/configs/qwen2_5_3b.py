"""Qwen2.5 3B [hf:Qwen; hf]: 36L d=2048 16H (GQA kv=2) d_ff=11008
vocab=151936, QKV bias, tied embeddings."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen2.5-3b", family="dense", n_layers=36, d_model=2048,
    n_heads=16, n_kv_heads=2, d_ff=11008, vocab=151936,
    qkv_bias=True, tied_embeddings=True, rope_theta=1e6)

SMOKE = ModelConfig(
    name="qwen2.5-3b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    qkv_bias=True, tied_embeddings=True)
