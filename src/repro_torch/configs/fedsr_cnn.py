"""The paper's CNN (3 conv + 2 FC, 319,178 params at 32x32x3, §IV-C) for
the FashionMNIST/CIFAR tasks."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="fedsr-cnn",
    family="cnn",
    num_layers=5,
    d_model=0,
    d_ff=0,
    vocab_size=0,
    image_size=32,
    image_channels=3,
    num_classes=10,
    cnn_channels=(32, 64, 64),
    source="FedSR paper §IV-C",
)

SMOKE = CONFIG  # already CPU-scale
