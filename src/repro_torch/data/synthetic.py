"""Synthetic class-conditional image tasks and the LM driver's token
streams (the port's copy of the JAX package's ``data/synthetic.py``).

Each class is a smooth random template; samples are shifted, scaled and
noised copies of it. The numpy generator is consumed in the reference's
order, so the same seed gives byte-identical datasets and token streams in
both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class Dataset:
    images: np.ndarray   # (N, H, W, C) float32 in [0, 1]
    labels: np.ndarray   # (N,) int32
    num_classes: int

    def __len__(self) -> int:
        return len(self.labels)


def _smooth_template(rng: np.random.Generator, size: int, channels: int) -> np.ndarray:
    """Low-frequency random pattern: sum of a few 2-D cosine modes."""
    yy, xx = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size), indexing="ij")
    img = np.zeros((size, size, channels), np.float32)
    for c in range(channels):
        for _ in range(4):
            fx, fy = rng.uniform(0.5, 3.0, 2)
            px, py = rng.uniform(0, 2 * np.pi, 2)
            amp = rng.uniform(0.3, 1.0)
            img[:, :, c] += amp * np.cos(2 * np.pi * (fx * xx + px)) * np.cos(
                2 * np.pi * (fy * yy + py)
            )
    img -= img.min()
    img /= max(img.max(), 1e-6)
    return img


def make_image_dataset(
    *,
    num_classes: int,
    size: int,
    channels: int,
    train_per_class: int,
    test_per_class: int,
    noise: float = 0.15,
    seed: int = 0,
) -> Tuple[Dataset, Dataset]:
    rng = np.random.default_rng(seed)
    templates = [_smooth_template(rng, size, channels) for _ in range(num_classes)]

    def sample(n_per_class: int) -> Dataset:
        imgs, labels = [], []
        for cls, tmpl in enumerate(templates):
            for _ in range(n_per_class):
                shift = rng.integers(-2, 3, size=2)
                img = np.roll(tmpl, shift, axis=(0, 1))
                img = img * rng.uniform(0.7, 1.3) + rng.normal(0, noise, img.shape)
                imgs.append(np.clip(img, 0, 1))
                labels.append(cls)
        imgs_arr = np.asarray(imgs, np.float32)
        labels_arr = np.asarray(labels, np.int32)
        perm = rng.permutation(len(labels_arr))
        return Dataset(imgs_arr[perm], labels_arr[perm], num_classes)

    return sample(train_per_class), sample(test_per_class)


_TASKS = {
    "mnist_like": {"num_classes": 10, "size": 28, "channels": 1},
    "fashionmnist_like": {"num_classes": 10, "size": 28, "channels": 1},
    "cifar10_like": {"num_classes": 10, "size": 32, "channels": 3},
    "cifar100_like": {"num_classes": 100, "size": 32, "channels": 3},
}


def make_task(
    task: str, *, train_per_class: int = 200, test_per_class: int = 40, seed: int = 0
) -> Tuple[Dataset, Dataset]:
    spec = dict(_TASKS[task])
    if task == "cifar100_like":
        train_per_class = max(train_per_class // 5, 20)
        test_per_class = max(test_per_class // 5, 10)
    # different seeds give different "datasets" per task name
    seed_offset = {"mnist_like": 0, "fashionmnist_like": 1,
                   "cifar10_like": 2, "cifar100_like": 3}[task]
    return make_image_dataset(
        train_per_class=train_per_class,
        test_per_class=test_per_class,
        seed=seed * 17 + seed_offset,
        **spec,
    )


def make_token_stream(
    *, vocab_size: int, num_tokens: int, seed: int = 0, branch: int = 4
) -> np.ndarray:
    """Order-1 Markov token stream: each token has ``branch`` likely
    successors (85%) plus uniform noise (15%). A small decoder can learn the
    bigram structure -> loss drops from ln(V) toward
    0.85*ln(branch) + 0.15*ln(V). Different seeds give different transition
    tables, so per-client streams are genuinely non-IID. The reference's
    draws, in its order, so the stream is the same token for token."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, vocab_size, size=(vocab_size, branch))
    noise = rng.random(num_tokens)
    pick = rng.integers(0, branch, size=num_tokens)
    uni = rng.integers(0, vocab_size, size=num_tokens)
    toks = np.empty(num_tokens, np.int32)
    prev = int(uni[0])
    for i in range(num_tokens):
        if noise[i] < 0.85:
            prev = int(table[prev, pick[i]])
        else:
            prev = int(uni[i])
        toks[i] = prev
    return toks
