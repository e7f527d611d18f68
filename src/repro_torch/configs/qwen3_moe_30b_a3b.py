"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B]: 48L d=2048 32H GQA(kv=4),
128 experts top-8, d_ff_expert=768, V=151936, qk_norm, head_dim=128."""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=0, vocab_size=151936, ffn_act="swiglu", qk_norm=True,
    rope_theta=1_000_000.0, dtype="bfloat16",
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768),
))
