"""yi-9b — dense llama-arch decoder with aggressive GQA (kv=4).

[arXiv:2403.04652] 48L, d_model=4096, 32H (GQA kv=4), d_ff=11008, vocab=64000.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import reduce_for_smoke

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=10_000.0,
    source="arXiv:2403.04652",
)

SMOKE = reduce_for_smoke(CONFIG)
