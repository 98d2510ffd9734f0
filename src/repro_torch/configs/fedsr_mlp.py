"""The paper's MLP (two hidden layers, 199,210 params at 28x28, §IV-C)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="fedsr-mlp",
    family="mlp",
    num_layers=3,
    d_model=0,
    d_ff=0,
    vocab_size=0,
    image_size=28,
    image_channels=1,
    num_classes=10,
    mlp_hidden=(200, 200),
    source="FedSR paper §IV-C",
)

SMOKE = CONFIG
