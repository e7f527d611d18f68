"""Phi-3-vision-4.2B [hf:microsoft/Phi-3-vision-128k-instruct]: phi3-mini
backbone 32L d=3072 32H MHA(kv=32) ff=8192 V=32064 + CLIP patch frontend
(stubbed: input_specs supplies 576 precomputed patch embeddings)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi-3-vision-4.2b", family="vlm", frontend="vision",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32064, ffn_act="swiglu", dtype="bfloat16",
    n_patches=576,
))
