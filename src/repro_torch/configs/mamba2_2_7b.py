"""mamba2-2.7b — attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060] 64L, d_model=2560, d_ff=0 (no FFN — the Mamba block is
the whole layer), vocab=50280, ssm_state=128, expand=2 (d_inner=5120),
headdim=64 (80 SSD heads), chunk=128. Natural long_500k arch: decode state
is O(1) per layer.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import reduce_for_smoke

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=128,
    source="arXiv:2405.21060",
)

SMOKE = reduce_for_smoke(CONFIG)
