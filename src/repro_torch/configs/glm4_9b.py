"""GLM-4-9B [hf:THUDM/glm-4-9b]: 40L d=4096 32H GQA(kv=2) ff=13696 V=151552."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab_size=151552, ffn_act="swiglu",
    rope_theta=10_000.0, dtype="bfloat16",
))
