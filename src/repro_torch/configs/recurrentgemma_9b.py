"""RecurrentGemma 9B [arXiv:2402.19427; unverified]: 38 blocks d=4096
16H (MQA kv=1, head_dim 256) d_ff=12288 vocab=256000; RG-LRU + local
attention in a 1:2 (attention:recurrence) pattern, window 2048."""
from repro_torch.models.config import HybridConfig, ModelConfig

FULL = ModelConfig(
    name="recurrentgemma-9b", family="hybrid", n_layers=38, d_model=4096,
    n_heads=16, n_kv_heads=1, head_dim=256, d_ff=12288, vocab=256000,
    mlp_act="geglu", tied_embeddings=True,
    hybrid=HybridConfig(pattern_rec=2, lru_width=4096, attn_window=2048))

SMOKE = ModelConfig(
    name="recurrentgemma-9b-smoke", family="hybrid", n_layers=5, d_model=64,
    n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128, vocab=512,
    mlp_act="geglu", tied_embeddings=True,
    hybrid=HybridConfig(pattern_rec=2, lru_width=64, attn_window=16))
