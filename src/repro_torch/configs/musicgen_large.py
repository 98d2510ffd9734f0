"""musicgen-large — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284] 48L, d_model=2048, 32 heads (MHA: kv=32), d_ff=8192,
vocab=2048 (EnCodec codebook). The EnCodec conv codec is the stubbed
modality frontend: the decoder is fed codebook token ids directly (its own
token embedding is part of the backbone). MusicGen uses learned positional
embeddings; the model uses RoPE, as the JAX package's config does.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import reduce_for_smoke

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    input_mode="tokens",
    rope_theta=10_000.0,
    source="arXiv:2306.05284",
)

SMOKE = reduce_for_smoke(CONFIG, num_kv_heads=4)
