"""LLaVA-NeXT 34B backbone [hf:llava-hf; unverified]: 60L d=7168 56H
(GQA kv=8) d_ff=20480 vocab=64000. Anyres vision tiling is STUBBED to a
fixed grid of precomputed patch embeddings (input_specs supplies them)."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="llava-next-34b", family="vlm", n_layers=60, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=20480, vocab=64000,
    rope_theta=5e6, n_vision_patches=2880)

SMOKE = ModelConfig(
    name="llava-next-34b-smoke", family="vlm", n_layers=2, d_model=64,
    n_heads=8, n_kv_heads=2, d_ff=128, vocab=512, n_vision_patches=8)
