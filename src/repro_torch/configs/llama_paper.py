"""The paper's own workloads (Table 11): LLaMA-350M / 1B / 7B on C4."""
from repro_torch.configs.base import ModelConfig, register

LLAMA_350M = register(ModelConfig(
    name="llama-350m", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=2736, vocab_size=32000, ffn_act="swiglu", dtype="bfloat16",
))
LLAMA_1B = register(ModelConfig(
    name="llama-1b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=5461, vocab_size=32000, ffn_act="swiglu", dtype="bfloat16",
))
LLAMA_7B = register(ModelConfig(
    name="llama-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab_size=32000, ffn_act="swiglu", dtype="bfloat16",
))
