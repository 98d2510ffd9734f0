"""qwen3-moe-30b-a3b — fine-grained MoE, 128 experts top-8.

[hf:Qwen/Qwen3-30B-A3B] 48L, d_model=2048, 32H (GQA kv=4), moe d_ff=768,
vocab=151936, 128 experts top-8, head_dim=128 (model card: q/k head dim 128,
decoupled from d_model/num_heads).
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import reduce_for_smoke

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    num_experts=128,
    experts_per_token=8,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-30B-A3B",
)

SMOKE = reduce_for_smoke(CONFIG)
