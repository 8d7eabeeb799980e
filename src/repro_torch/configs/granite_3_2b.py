"""Granite 3.0 2B [hf:ibm-granite; hf]: 40L d=2048 32H (GQA kv=8)
d_ff=8192 vocab=49155, tied embeddings."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="granite-3-2b", family="dense", n_layers=40, d_model=2048,
    n_heads=32, n_kv_heads=8, d_ff=8192, vocab=49155,
    tied_embeddings=True)

SMOKE = ModelConfig(
    name="granite-3-2b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=8, n_kv_heads=2, d_ff=128, vocab=512, tied_embeddings=True)
