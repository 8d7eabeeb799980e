"""Mamba-2 780M [arXiv:2405.21060; unverified]: 48L d=1536, attention-free,
SSD (state-space duality), ssm_state=128, vocab=50280."""
from repro_torch.models.config import ModelConfig, SSMConfig

FULL = ModelConfig(
    name="mamba2-780m", family="ssm", n_layers=48, d_model=1536,
    n_heads=0, n_kv_heads=0, d_ff=0, vocab=50280, tied_embeddings=True,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4,
                  chunk=256))

SMOKE = ModelConfig(
    name="mamba2-780m-smoke", family="ssm", n_layers=2, d_model=64,
    n_heads=0, n_kv_heads=0, d_ff=0, vocab=512, tied_embeddings=True,
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_width=4, chunk=16))
