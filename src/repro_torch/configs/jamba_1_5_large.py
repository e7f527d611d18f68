"""Jamba-1.5-Large 398B [arXiv:2403.19887]: 72L d=8192, attn:mamba 1:7
interleave (1 attention layer per 8), MoE 16e top-2 every 2nd layer
(d_ff=24576 dense and per-expert), 64H GQA(kv=8), V=65536.
The Mamba sublayers use the Mamba2/SSD mixer (the paper used Mamba-1), as
the JAX package does."""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab_size=65536, ffn_act="swiglu", dtype="bfloat16",
    attn_every=8, attn_offset=0,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576, every=2, offset=1),
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64, d_conv=4, chunk=256),
))
