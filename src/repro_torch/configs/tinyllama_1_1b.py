"""TinyLlama 1.1B [arXiv:2401.02385; hf]: 22L d=2048 32H (GQA kv=4)
d_ff=5632 vocab=32000 — llama2-architecture small model."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="tinyllama-1.1b", family="dense", n_layers=22, d_model=2048,
    n_heads=32, n_kv_heads=4, d_ff=5632, vocab=32000)

SMOKE = ModelConfig(
    name="tinyllama-1.1b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=8, n_kv_heads=2, d_ff=128, vocab=512)
