"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave with MoE.

[arXiv:2403.19887] 32L, d_model=4096, 32H (GQA kv=8), d_ff=14336,
vocab=65536, MoE 16 experts top-2. Layer pattern (period 8, model card):
attention at offset 4 of each 8-layer block (attn_layer_period=8,
attn_layer_offset=4), MoE FFN every 2nd layer (expert_layer_period=2,
expert_layer_offset=1). Jamba's SSM layers are Mamba-1; the model runs them
in the Mamba2/SSD dual form (same recurrence class, chunked matmuls), as
the JAX package does.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import reduce_for_smoke

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    num_experts=16,
    experts_per_token=2,
    moe_every=2,
    moe_offset=1,
    attn_every=8,
    attn_offset=4,
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=128,
    rope_theta=10_000.0,
    source="arXiv:2403.19887",
)

SMOKE = reduce_for_smoke(CONFIG)
