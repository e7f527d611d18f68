"""Nemotron-4-340B [arXiv:2402.16819]: 96L d=18432 96H GQA(kv=8) ff=73728
V=256000 — squared-ReLU FFN (no gate)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8,
    d_ff=73728, vocab_size=256000, ffn_act="relu2", dtype="bfloat16",
))
