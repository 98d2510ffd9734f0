"""stablelm-12b — dense llama-arch decoder.

[hf:stabilityai/stablelm-2-12b] 40L, d_model=5120, 32H (GQA kv=8),
d_ff=13824, vocab=100352. head_dim = 5120/32 = 160.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import reduce_for_smoke

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    rope_theta=10_000.0,
    source="hf:stabilityai/stablelm-2-12b (assignment: stablelm-2-1_6b card scaled)",
)

SMOKE = reduce_for_smoke(CONFIG)
