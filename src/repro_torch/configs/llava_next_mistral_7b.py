"""llava-next-mistral-7b — VLM backbone (mistral-7b) with anyres tiling.

[hf:llava-hf/llava-v1.6-mistral-7b-hf] 32L, d_model=4096, 32H (GQA kv=8),
d_ff=14336, vocab=32000. The vision tower and projector are the stubbed
modality frontend: the backbone is fed pre-projected patch and token
embeddings of shape (B, S, d_model) (``input_mode='embeds'``, so the model
has no embedding table). Mistral's sliding-window attention (4096) is
implemented.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import reduce_for_smoke

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    input_mode="embeds",
    sliding_window=4096,
    rope_theta=10_000.0,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)

SMOKE = reduce_for_smoke(CONFIG)
