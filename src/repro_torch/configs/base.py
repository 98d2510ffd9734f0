"""Config dataclasses of the PyTorch port — its own copy of the JAX
package's ``ModelConfig``, ``FLConfig``, the frozen sub-configs
``FLConfig`` holds and ``TrainConfig``, with the same fields, defaults and
validation.

The port imports nothing of the JAX package, so the two packages keep two
copies; ``tests/test_torch_fedsr.py`` pins that their fields and defaults
agree. Options the port does not run yet are still accepted here (a config
is data); the modules that would act on them raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio | cnn | mlp
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0               # 0 -> d_model // num_heads
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1
    moe_offset: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_grouped_dispatch: bool = False
    rolling_cache: bool = False
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 128
    ssm_conv: int = 4
    ssd_intra_dtype: str = "float32"
    # --- hybrid (Jamba) ---
    attn_every: int = 0
    attn_offset: int = 0
    # --- attention options ---
    sliding_window: int = 0
    attn_block: int = 0
    rope_theta: float = 10_000.0
    # --- inputs ---
    input_mode: str = "tokens"
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    scan_layers: bool = True
    # --- small models for the paper's own experiments ---
    image_size: int = 28
    image_channels: int = 1
    num_classes: int = 10
    mlp_hidden: Tuple[int, ...] = (200, 200)
    cnn_channels: Tuple[int, ...] = (32, 64, 64)
    source: str = ""                # citation for the config

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    def moe_on_layer(self, layer: int) -> bool:
        if self.num_experts <= 0:
            return False
        return layer % max(self.moe_every, 1) == self.moe_offset


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """Straggler/dropout knobs (``core.scenario``): per-round drops, a
    train-slow subset whose visits are truncated, a send-slow subset whose
    uploads arrive stale, and the simulated clock (``rate_min``,
    ``rate_max``, ``transfer_seconds``, ``time_threshold``), which runs
    whether or not the scenario is ``active``."""
    drop_rate: float = 0.0
    train_slow_frac: float = 0.0
    send_slow_frac: float = 0.0
    slow_step_factor: float = 0.5
    staleness_horizon: int = 4
    staleness_decay: float = 0.5
    rate_min: float = 1.0
    rate_max: float = 1.0
    transfer_seconds: float = 0.0
    time_threshold: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if not 0.0 <= self.drop_rate < 1.0:
            raise ValueError(f"drop_rate={self.drop_rate} must be in [0, 1)")
        for name in ("train_slow_frac", "send_slow_frac"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name}={v} must be in [0, 1]")
        if not 0.0 < self.slow_step_factor <= 1.0:
            raise ValueError(
                f"slow_step_factor={self.slow_step_factor} must be in (0, 1]")
        if self.staleness_horizon < 0:
            raise ValueError(
                f"staleness_horizon={self.staleness_horizon} must be >= 0")
        if self.staleness_decay < 0:
            raise ValueError(
                f"staleness_decay={self.staleness_decay} must be >= 0")
        if not 0.0 < self.rate_min <= self.rate_max:
            raise ValueError(
                f"need 0 < rate_min <= rate_max, got "
                f"[{self.rate_min}, {self.rate_max}]")
        if self.transfer_seconds < 0 or self.time_threshold < 0:
            raise ValueError("transfer_seconds/time_threshold must be >= 0")

    @property
    def active(self) -> bool:
        """True when any knob perturbs training (the clock-only knobs
        never touch plans)."""
        return (self.drop_rate > 0 or self.train_slow_frac > 0
                or self.send_slow_frac > 0)


@dataclasses.dataclass(frozen=True)
class AdversaryConfig:
    """Attacker-model knobs (``core.adversary``): a ``frac`` of the fleet
    flips its labels, or uploads a sign-flipped or ``scale``-amplified
    delta."""
    frac: float = 0.0
    kind: str = "sign_flip"         # label_flip | sign_flip | scale
    scale: float = 10.0
    seed: int = 0

    def __post_init__(self):
        if not 0.0 <= self.frac <= 1.0:
            raise ValueError(f"frac={self.frac} must be in [0, 1]")
        if self.kind not in ("label_flip", "sign_flip", "scale"):
            raise ValueError(
                f"kind={self.kind!r} must be label_flip|sign_flip|scale")
        if self.scale <= 0:
            raise ValueError(f"scale={self.scale} must be > 0")

    @property
    def active(self) -> bool:
        return self.frac > 0


@dataclasses.dataclass(frozen=True)
class PersonalizeConfig:
    """Post-global personalization stage (``core.personalize``): with
    ``epochs > 0`` every client fine-tunes the final global model on its
    own shard after the last round. Field meanings are those of the JAX
    package's ``PersonalizeConfig``; the default (``epochs=0``) runs and
    draws nothing."""
    epochs: int = 0
    lr: float = 0.01
    mode: str = "full"              # full | head
    batch_size: int = 0
    block: int = 0
    eval_per_client: int = 64
    seed: int = 0

    def __post_init__(self):
        if self.epochs < 0:
            raise ValueError(f"epochs={self.epochs} must be >= 0 (0 = off)")
        if self.lr <= 0:
            raise ValueError(f"lr={self.lr} must be > 0")
        if self.mode not in ("full", "head"):
            raise ValueError(f"mode={self.mode!r} must be 'full' or 'head'")
        if self.batch_size < 0 or self.block < 0:
            raise ValueError("batch_size/block must be >= 0 (0 = default)")
        if self.eval_per_client <= 0:
            raise ValueError(
                f"eval_per_client={self.eval_per_client} must be > 0")

    @property
    def active(self) -> bool:
        return self.epochs > 0


@dataclasses.dataclass(frozen=True)
class FLConfig:
    """Hyper-parameters of Algorithm 1 and of all baselines (paper §IV-C/D).
    Field meanings are those of the JAX package's ``FLConfig``."""
    algorithm: str = "fedsr"         # fedsr | fedavg | fedprox | moon | hieravg | ring | centralized
    num_devices: int = 20            # K
    num_edges: int = 5               # M (= number of ring clusters)
    local_epochs: int = 1            # E
    ring_rounds: int = 5             # R (laps of the ring per global round)
    rounds: int = 50                 # global rounds T
    participation: float = 1.0       # device sample fraction per round
    partition: str = "iid"           # iid | pathological | dirichlet
    xi: int = 2                      # pathological shards-per-device
    alpha: float = 0.3               # dirichlet concentration
    batch_size: int = 32
    init_lr: float = 0.01
    final_lr: float = 1e-5
    momentum: float = 0.5
    mu: float = 0.01
    moon_tau: float = 0.5
    seed: int = 0
    reshuffle_ring: bool = True
    engine: str = "sequential"       # sequential | batched | sharded | fused
    mesh_data_axis: Optional[str] = None
    store: str = "device"            # device | host | stream
    prefetch: int = 0                # 0 serial block loop | 1 one-block lookahead
    use_fused_sgd: bool = False      # the momentum update as one fused
                                     # kernel pass (CUDA on the GPU)
    scenario: ScenarioConfig = dataclasses.field(
        default_factory=ScenarioConfig)
    adversary: AdversaryConfig = dataclasses.field(
        default_factory=AdversaryConfig)
    personalize: PersonalizeConfig = dataclasses.field(
        default_factory=PersonalizeConfig)
    reducer: str = "weighted_mean"   # weighted_mean | median | trimmed_mean | krum
    trim_frac: float = 0.2
    krum_f: int = 1
    dp_clip: float = 0.0
    dp_noise_mult: float = 0.0
    dp_delta: float = 1e-5
    dp_seed: int = 0

    def __post_init__(self):
        if not 0.0 < self.participation <= 1.0:
            raise ValueError(
                f"participation={self.participation} must be in (0, 1] "
                "(a fraction of devices sampled per round)")
        if self.store not in ("device", "host", "stream"):
            raise ValueError(
                f"store={self.store!r} must be 'device', 'host' or 'stream'")
        if self.prefetch not in (0, 1):
            raise ValueError(
                f"prefetch={self.prefetch} must be 0 (serial block loop) or 1 "
                "(one-block lookahead)")
        if self.reducer not in ("weighted_mean", "median", "trimmed_mean",
                                "krum"):
            raise ValueError(
                f"reducer={self.reducer!r} must be weighted_mean|median|"
                "trimmed_mean|krum")
        if not 0.0 <= self.trim_frac < 0.5:
            raise ValueError(
                f"trim_frac={self.trim_frac} must be in [0, 0.5)")
        if self.krum_f < 0:
            raise ValueError(f"krum_f={self.krum_f} must be >= 0")
        if self.dp_clip < 0 or self.dp_noise_mult < 0:
            raise ValueError("dp_clip/dp_noise_mult must be >= 0")
        if not 0.0 < self.dp_delta < 1.0:
            raise ValueError(f"dp_delta={self.dp_delta} must be in (0, 1)")

    @property
    def devices_per_edge(self) -> int:
        if self.num_edges <= 0 or self.num_devices % self.num_edges != 0:
            raise ValueError(
                f"num_edges={self.num_edges} must divide "
                f"num_devices={self.num_devices} evenly")
        return self.num_devices // self.num_edges


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Large-architecture runtime knobs (``launch/train.py``,
    ``launch/steps.py::make_train_step``). The LM step reads
    ``learning_rate``, ``momentum``, ``remat``, ``ring_mode``,
    ``cloud_sync_every`` (the loop), ``param_dtype``, ``fused_sgd`` and
    ``hop_momentum``; like the reference's, it ignores ``optimizer``,
    ``weight_decay``, ``compute_dtype``, ``dp_clip`` and ``dp_noise_mult``
    (ROADMAP C11)."""
    optimizer: str = "sgd"           # sgd (faithful FedSR client opt) | adamw
    learning_rate: float = 0.01
    momentum: float = 0.5
    weight_decay: float = 0.0
    remat: str = "none"              # none | full | selective
    ring_mode: str = "pipelined"     # pipelined: Q incremental chains in
                                     #   flight, ring hop = a roll of the
                                     #   client stack (the baseline);
                                     # serial: ONE chain over the ring
                                     #   positions inside the step — literal
                                     #   Alg. 1 semantics
    cloud_sync_every: int = 5        # R: ring laps between cloud aggregations
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    fused_sgd: bool = False
    dp_clip: float = 0.0             # >0 opts the large-model runtime into
                                     # DP-SGD (per-device L2 gradient clip)
    dp_noise_mult: float = 0.0       # Gaussian noise std = dp_noise_mult * clip
    hop_momentum: bool = True        # baseline: momentum travels with the
                                     # model on the ring hop; False = it
                                     # stays device-local (paper Alg. 1 keeps
                                     # optimizer state on the device)
