"""Qwen3-0.6B [hf:Qwen/Qwen3-8B family]: 28L d=1024 16H GQA(kv=8) ff=3072
V=151936 — qk_norm, decoupled head_dim=128, tied embeddings."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=3072, vocab_size=151936, ffn_act="swiglu", qk_norm=True,
    rope_theta=1_000_000.0, tie_embeddings=True, dtype="bfloat16",
))
