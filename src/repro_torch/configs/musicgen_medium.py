"""MusicGen-medium [arXiv:2306.05284]: 48L d=1536 24H MHA(kv=24) ff=6144
V=2048 — decoder over EnCodec tokens; frame-embedding frontend is a stub
(input_specs supplies precomputed embeddings). Non-gated gelu MLP."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-medium", family="audio", frontend="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab_size=2048, ffn_act="gelu", dtype="bfloat16",
))
