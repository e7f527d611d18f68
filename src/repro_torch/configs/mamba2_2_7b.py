"""Mamba2-2.7B [arXiv:2405.21060]: 64L d=2560 attn-free SSD, d_state=128,
expand=2, head_dim=64, V=50280 (padded to 50304 for TP), tied embeddings."""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab_size=50280, tie_embeddings=True, dtype="bfloat16",
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, d_conv=4, chunk=256),
))
