"""Whisper-medium backbone [arXiv:2212.04356; unverified]: enc-dec, 24L each,
d=1024 16H d_ff=4096 vocab=51865. Conv audio frontend is STUBBED: input_specs
provides precomputed frame embeddings [B, 1500, d]. (kv=16 => MHA.)"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="whisper-medium", family="encdec", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=4096, vocab=51865, mlp_act="gelu",
    tied_embeddings=True, n_encoder_layers=24, encoder_len=1500)

SMOKE = ModelConfig(
    name="whisper-medium-smoke", family="encdec", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=512, mlp_act="gelu",
    tied_embeddings=True, n_encoder_layers=2, encoder_len=16)
