"""phi3.5-moe-42b-a6.6b — MoE, 16 experts top-2.

[hf:microsoft/Phi-3.5-MoE-instruct] 32L, d_model=4096, 32H (GQA kv=8),
moe d_ff=6400, vocab=32064, 16 experts top-2.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import reduce_for_smoke

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    num_experts=16,
    experts_per_token=2,
    rope_theta=10_000.0,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)

SMOKE = reduce_for_smoke(CONFIG)
