"""Command R+ 104B [hf:CohereForAI; unverified]: 64L d=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000, no attention bias, tied embeddings."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="command-r-plus-104b", family="dense", n_layers=64, d_model=12288,
    n_heads=96, n_kv_heads=8, d_ff=33792, vocab=256000,
    tied_embeddings=True, rope_theta=75e6)

SMOKE = ModelConfig(
    name="command-r-plus-104b-smoke", family="dense", n_layers=2, d_model=96,
    n_heads=8, n_kv_heads=2, d_ff=192, vocab=512, tied_embeddings=True)
