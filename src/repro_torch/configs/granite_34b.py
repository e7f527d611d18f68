"""Granite-34B-Code [arXiv:2405.04324]: 88L d=6144 48H MQA(kv=1) ff=24576
V=49152 — non-gated (gelu) 4x MLP, which is what makes the count 34B."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab_size=49152, ffn_act="gelu", dtype="bfloat16",
))
