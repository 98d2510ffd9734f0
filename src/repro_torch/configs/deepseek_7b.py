"""deepseek-7b — dense llama-arch decoder (MHA).

[arXiv:2401.02954] 30L, d_model=4096, 32H (kv=32), d_ff=11008, vocab=102400.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import reduce_for_smoke

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    rope_theta=10_000.0,
    source="arXiv:2401.02954",
)

SMOKE = reduce_for_smoke(CONFIG, num_kv_heads=4)
