"""Typed configuration: the JAX package's ``Config`` for the PyTorch engine.

Port of ``deepspeed_tpu/runtime/config.py`` (dataclasses with ``from_dict``
constructors over the DeepSpeed JSON vocabulary) with a minimal copy of
``comm/mesh.py``'s ``MeshConfig``. The port trains on one device: a mesh
resolves only to one device, and one that asks for more raises
``NotImplementedError`` (ROADMAP A9). An unknown key raises
:class:`ConfigError` naming it; keys the JAX package accepts and ignores
are logged and ignored here too.

The batch invariant is the reference's:

    train_batch_size == micro_batch_per_device × grad_accum_steps × dp_world

and any two of the three knobs determine the third.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Optional

import torch

from ..utils.logging import logger
from . import constants as C


class ConfigError(Exception):
    pass


MESH_AXES = ("pp", "dp", "fsdp", "ep", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes for each mesh axis; ``-1`` absorbs the remaining devices (a
    copy of ``deepspeed_tpu/comm/mesh.py:MeshConfig`` for one device)."""

    pp: int = 1
    dp: int = -1
    fsdp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    def resolve(self, n_devices: int = 1) -> "MeshConfig":
        sizes = {a: getattr(self, a) for a in MESH_AXES}
        wild = [a for a, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one mesh axis may be -1, got {wild}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if n_devices != 1 or fixed != 1:
            raise NotImplementedError(
                f"a mesh over {max(n_devices, fixed)} devices ({self.as_dict()}) is not "
                "ported: the PyTorch engine trains on one device (ROADMAP.md A9)")
        return MeshConfig(**{a: 1 for a in MESH_AXES})

    @staticmethod
    def from_dict(d: dict) -> "MeshConfig":
        unknown = set(d) - set(MESH_AXES)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; valid: {MESH_AXES}")
        known = {k: int(v) for k, v in d.items()}
        if any(v == -1 for v in known.values()):
            return MeshConfig(**{**{a: 1 for a in MESH_AXES}, **known})
        return MeshConfig(**known)

    def as_dict(self) -> dict:
        return {a: getattr(self, a) for a in MESH_AXES}


@dataclasses.dataclass
class OptimizerConfig:
    type: str = C.ADAMW_OPTIMIZER
    lr: float = 1e-3
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    extra: dict = dataclasses.field(default_factory=dict)

    @staticmethod
    def from_dict(d: Optional[dict]) -> "OptimizerConfig":
        if not d:
            return OptimizerConfig()
        typ = str(d.get(C.TYPE, C.ADAMW_OPTIMIZER)).lower()
        params = dict(d.get(C.PARAMS, {}) or {})
        known = {}
        for key, conv in (("lr", float), ("betas", tuple), ("eps", float),
                          ("weight_decay", float)):
            if key in params:
                known[key] = conv(params.pop(key))
        return OptimizerConfig(type=typ, extra=params, **known)


@dataclasses.dataclass
class SchedulerConfig:
    type: Optional[str] = None
    params: dict = dataclasses.field(default_factory=dict)

    @staticmethod
    def from_dict(d: Optional[dict]) -> "SchedulerConfig":
        if not d:
            return SchedulerConfig()
        return SchedulerConfig(type=d.get(C.TYPE), params=dict(d.get(C.PARAMS, {}) or {}))


@dataclasses.dataclass
class Float16Config:
    """fp16 with dynamic loss scaling (reference ``runtime/fp16/loss_scaler.py``)."""

    enabled: bool = False
    loss_scale: float = 0.0  # 0 → dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    min_loss_scale: float = 1.0

    @staticmethod
    def from_dict(d: Optional[dict]) -> "Float16Config":
        if not d:
            return Float16Config()
        return Float16Config(
            enabled=bool(d.get(C.ENABLED, False)),
            loss_scale=float(d.get("loss_scale", 0.0)),
            initial_scale_power=int(d.get("initial_scale_power", 16)),
            loss_scale_window=int(d.get("loss_scale_window", 1000)),
            hysteresis=int(d.get("hysteresis", 2)),
            min_loss_scale=float(d.get("min_loss_scale", 1.0)))


@dataclasses.dataclass
class BFloat16Config:
    enabled: bool = True

    @staticmethod
    def from_dict(d: Optional[dict]) -> "BFloat16Config":
        if not d:
            return BFloat16Config()
        return BFloat16Config(enabled=bool(d.get(C.ENABLED, True)))


@dataclasses.dataclass
class OffloadConfig:
    device: str = "none"  # none | cpu | nvme
    nvme_path: Optional[str] = None
    pin_memory: bool = True

    @staticmethod
    def from_dict(d: Optional[dict]) -> "OffloadConfig":
        if not d:
            return OffloadConfig()
        return OffloadConfig(device=str(d.get("device", "none")), nvme_path=d.get("nvme_path"),
                             pin_memory=bool(d.get("pin_memory", True)))


@dataclasses.dataclass
class ZeroConfig:
    """ZeRO stages 0–3. On one device every stage is the same computation
    (the JAX package shards over a mesh of one); bucket and overlap knobs
    are accepted and unused, as there."""

    stage: int = 0
    offload_optimizer: OffloadConfig = dataclasses.field(default_factory=OffloadConfig)
    offload_param: OffloadConfig = dataclasses.field(default_factory=OffloadConfig)
    allgather_bucket_size: int = int(5e8)
    reduce_bucket_size: int = int(5e8)
    overlap_comm: bool = True
    contiguous_gradients: bool = True
    zero3_gather_16bit_weights_on_model_save: bool = False

    @staticmethod
    def from_dict(d: Optional[dict]) -> "ZeroConfig":
        if not d:
            return ZeroConfig()
        stage = int(d.get(C.ZERO_STAGE, 0))
        if stage not in (0, 1, 2, 3):
            raise ConfigError(f"zero_optimization.stage must be 0-3, got {stage}")
        return ZeroConfig(
            stage=stage,
            offload_optimizer=OffloadConfig.from_dict(d.get("offload_optimizer")),
            offload_param=OffloadConfig.from_dict(d.get("offload_param")),
            allgather_bucket_size=int(d.get("allgather_bucket_size", int(5e8))),
            reduce_bucket_size=int(d.get("reduce_bucket_size", int(5e8))),
            overlap_comm=bool(d.get("overlap_comm", True)),
            contiguous_gradients=bool(d.get("contiguous_gradients", True)),
            zero3_gather_16bit_weights_on_model_save=bool(
                d.get("stage3_gather_16bit_weights_on_model_save",
                      d.get("zero3_gather_16bit_weights_on_model_save", False))))


@dataclasses.dataclass
class ActivationCheckpointingConfig:
    """Selects the remat policy applied per block (``models/common.py``
    ``resolve_remat_policy``)."""

    enabled: bool = False
    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    policy: str = "nothing_saveable"

    @staticmethod
    def from_dict(d: Optional[dict]) -> "ActivationCheckpointingConfig":
        if not d:
            return ActivationCheckpointingConfig()
        return ActivationCheckpointingConfig(
            # the section's presence means enabled unless it says otherwise
            enabled=bool(d.get("enabled", True)),
            partition_activations=bool(d.get("partition_activations", False)),
            cpu_checkpointing=bool(d.get("cpu_checkpointing", False)),
            contiguous_memory_optimization=bool(d.get("contiguous_memory_optimization", False)),
            number_checkpoints=d.get("number_checkpoints"),
            policy=str(d.get("policy", "nothing_saveable")))


@dataclasses.dataclass
class MonitorConfig:
    tensorboard: dict = dataclasses.field(default_factory=dict)
    wandb: dict = dataclasses.field(default_factory=dict)
    csv_monitor: dict = dataclasses.field(default_factory=dict)

    @property
    def enabled(self) -> bool:
        return any(bool(c.get("enabled")) for c in (self.tensorboard, self.wandb, self.csv_monitor))


_DICT_SECTIONS = {   # attribute ← JSON key of the pass-through dict sections
    "pipeline": C.PIPELINE, "curriculum_learning": C.CURRICULUM_LEARNING,
    "progressive_layer_drop": C.PROGRESSIVE_LAYER_DROP, "eigenvalue": C.EIGENVALUE,
    "quantize_training": C.QUANTIZE_TRAINING, "flops_profiler": C.FLOPS_PROFILER,
    "elasticity": C.ELASTICITY, "autotuning": C.AUTOTUNING,
    "sparse_attention": C.SPARSE_ATTENTION, "model_overrides": "model_overrides",
    "autotuned": "autotuned",
}


@dataclasses.dataclass
class Config:
    """Top-level config (reference ``DeepSpeedConfig``)."""

    train_batch_size: int = 0
    train_micro_batch_size_per_gpu: int = 0
    gradient_accumulation_steps: int = 0

    steps_per_print: int = C.STEPS_PER_PRINT_DEFAULT
    gradient_clipping: float = C.GRADIENT_CLIPPING_DEFAULT
    prescale_gradients: bool = False
    gradient_predivide_factor: float = 1.0
    seed: int = 1234

    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    fp16: Float16Config = dataclasses.field(default_factory=Float16Config)
    bf16: BFloat16Config = dataclasses.field(default_factory=BFloat16Config)
    zero: ZeroConfig = dataclasses.field(default_factory=ZeroConfig)
    activation_checkpointing: ActivationCheckpointingConfig = dataclasses.field(
        default_factory=ActivationCheckpointingConfig)
    monitor: MonitorConfig = dataclasses.field(default_factory=MonitorConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    mesh_dcn: Optional[dict] = None
    # data_types.grad_accum_dtype: the dtype micro-batch gradients are
    # accumulated in ("fp32" or "bf16"); the update runs in fp32 either way
    grad_accum_dtype: str = "fp32"
    model_overrides: dict = dataclasses.field(default_factory=dict)
    autotuned: dict = dataclasses.field(default_factory=dict)

    wall_clock_breakdown: bool = False
    memory_breakdown: bool = False
    communication_data_type: Optional[str] = None
    dataloader_drop_last: bool = True
    sparse_gradients: bool = False
    sparse_gradient_modules: list = dataclasses.field(default_factory=list)

    pipeline: dict = dataclasses.field(default_factory=dict)
    curriculum_learning: dict = dataclasses.field(default_factory=dict)
    progressive_layer_drop: dict = dataclasses.field(default_factory=dict)
    eigenvalue: dict = dataclasses.field(default_factory=dict)
    quantize_training: dict = dataclasses.field(default_factory=dict)
    flops_profiler: dict = dataclasses.field(default_factory=dict)
    elasticity: dict = dataclasses.field(default_factory=dict)
    autotuning: dict = dataclasses.field(default_factory=dict)
    sparse_attention: dict = dataclasses.field(default_factory=dict)

    raw: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def dtype(self) -> torch.dtype:
        if self.fp16.enabled:
            return torch.float16
        if self.bf16.enabled:
            return torch.bfloat16
        return torch.float32

    def data_parallel_world(self, n_devices: int = 1) -> int:
        m = self.mesh.resolve(n_devices)
        return m.dp * m.fsdp * m.ep

    def resolve_batch(self, n_devices: int = 1) -> None:
        """Cross-derive the batch triple (reference ``_set_batch_related_parameters``)."""
        dp = self.data_parallel_world(n_devices)
        tbs, mbs, gas = (self.train_batch_size, self.train_micro_batch_size_per_gpu,
                         self.gradient_accumulation_steps)
        given = [bool(tbs), bool(mbs), bool(gas)]
        if all(given):
            if tbs != mbs * gas * dp:
                raise ConfigError(
                    f"batch arithmetic violated: train_batch_size({tbs}) != "
                    f"micro({mbs}) * grad_accum({gas}) * dp_world({dp})")
        elif given == [True, True, False]:
            if tbs % (mbs * dp):
                raise ConfigError(f"train_batch_size({tbs}) not divisible by micro({mbs})*dp({dp})")
            gas = tbs // (mbs * dp)
        elif given == [True, False, True]:
            if tbs % (gas * dp):
                raise ConfigError(f"train_batch_size({tbs}) not divisible by gas({gas})*dp({dp})")
            mbs = tbs // (gas * dp)
        elif given == [False, True, True]:
            tbs = mbs * gas * dp
        elif given == [True, False, False]:
            if tbs % dp:
                raise ConfigError(f"train_batch_size({tbs}) not divisible by dp_world({dp})")
            mbs, gas = tbs // dp, 1
        elif given == [False, True, False]:
            gas, tbs = 1, mbs * dp
        else:
            raise ConfigError("must supply train_batch_size or train_micro_batch_size_per_gpu")
        self.train_batch_size = tbs
        self.train_micro_batch_size_per_gpu = mbs
        self.gradient_accumulation_steps = gas

    _KNOWN_UNSUPPORTED = {"amp", "zero_allow_untested_optimizer", "checkpoint",
                          "comms_logger", "compression_training"}

    @staticmethod
    def from_dict(d: dict) -> "Config":
        d = dict(d or {})
        mesh_d = d.get(C.MESH, {}) or {}

        def section(key):
            return dict(d.get(key, {}) or {})

        cfg = Config(
            train_batch_size=int(d.get(C.TRAIN_BATCH_SIZE, 0) or 0),
            train_micro_batch_size_per_gpu=int(d.get(C.TRAIN_MICRO_BATCH_SIZE_PER_GPU, 0) or 0),
            gradient_accumulation_steps=int(d.get(C.GRADIENT_ACCUMULATION_STEPS, 0) or 0),
            steps_per_print=int(d.get(C.STEPS_PER_PRINT, C.STEPS_PER_PRINT_DEFAULT)),
            gradient_clipping=float(d.get(C.GRADIENT_CLIPPING, 0.0)),
            prescale_gradients=bool(d.get(C.PRESCALE_GRADIENTS, False)),
            gradient_predivide_factor=float(d.get(C.GRADIENT_PREDIVIDE_FACTOR, 1.0)),
            seed=int(d.get(C.SEED, 1234)),
            optimizer=OptimizerConfig.from_dict(d.get(C.OPTIMIZER)),
            scheduler=SchedulerConfig.from_dict(d.get(C.SCHEDULER)),
            fp16=Float16Config.from_dict(d.get(C.FP16)),
            bf16=BFloat16Config.from_dict(d.get(C.BF16)),
            zero=ZeroConfig.from_dict(d.get(C.ZERO_OPTIMIZATION)),
            activation_checkpointing=ActivationCheckpointingConfig.from_dict(
                d.get(C.ACTIVATION_CHECKPOINTING)),
            monitor=MonitorConfig(tensorboard=section(C.TENSORBOARD), wandb=section(C.WANDB),
                                  csv_monitor=section(C.CSV_MONITOR)),
            mesh=MeshConfig.from_dict({k: v for k, v in mesh_d.items() if k != "dcn"}),
            mesh_dcn=mesh_d.get("dcn"),
            grad_accum_dtype=str(section("data_types").get("grad_accum_dtype", "fp32")).lower(),
            wall_clock_breakdown=bool(d.get(C.WALL_CLOCK_BREAKDOWN, False)),
            memory_breakdown=bool(d.get(C.MEMORY_BREAKDOWN, False)),
            communication_data_type=d.get(C.COMMUNICATION_DATA_TYPE),
            dataloader_drop_last=bool(d.get(C.DATALOADER_DROP_LAST, True)),
            sparse_gradients=bool(d.get(C.SPARSE_GRADIENTS, False)),
            sparse_gradient_modules=list(d.get(C.SPARSE_GRADIENT_MODULES, []) or []),
            raw=d,
            **{attr: section(key) for attr, key in _DICT_SECTIONS.items()})
        if cfg.fp16.enabled and cfg.bf16.enabled and C.BF16 not in d:
            cfg.bf16 = BFloat16Config(enabled=False)   # fp16 asked for; the bf16 default yields
        if cfg.fp16.enabled and cfg.bf16.enabled:
            raise ConfigError("fp16 and bf16 cannot both be enabled")
        if cfg.grad_accum_dtype not in ("fp32", "float32", "bf16", "bfloat16"):
            raise ConfigError(f"data_types.grad_accum_dtype {cfg.grad_accum_dtype!r}: "
                              "valid values are fp32|bf16")
        if cfg.grad_accum_dtype in ("bf16", "bfloat16") and cfg.fp16.enabled:
            raise ConfigError("data_types.grad_accum_dtype=bf16 requires bf16 training "
                              "(fp16 loss scaling needs fp32 gradient accumulation)")
        known_keys = {
            C.TRAIN_BATCH_SIZE, C.TRAIN_MICRO_BATCH_SIZE_PER_GPU, C.GRADIENT_ACCUMULATION_STEPS,
            C.STEPS_PER_PRINT, C.GRADIENT_CLIPPING, C.PRESCALE_GRADIENTS,
            C.GRADIENT_PREDIVIDE_FACTOR, C.SEED, C.OPTIMIZER, C.SCHEDULER, C.FP16, C.BF16,
            C.ZERO_OPTIMIZATION, C.ACTIVATION_CHECKPOINTING, C.TENSORBOARD, C.WANDB,
            C.CSV_MONITOR, C.MESH, C.WALL_CLOCK_BREAKDOWN, C.MEMORY_BREAKDOWN,
            C.COMMUNICATION_DATA_TYPE, C.DATALOADER_DROP_LAST, C.SPARSE_GRADIENTS,
            C.SPARSE_GRADIENT_MODULES, "data_types", *_DICT_SECTIONS.values(),
        }
        for key in d:
            if key in known_keys:
                continue
            if key in Config._KNOWN_UNSUPPORTED:
                logger.warning(f"config key '{key}' accepted but not supported; ignored")
            else:
                raise ConfigError(f"unknown config key '{key}'")
        return cfg

    @staticmethod
    def from_file(path: str) -> "Config":
        with open(path) as fh:
            return Config.from_dict(json.load(fh))

    @staticmethod
    def load(config: "Config | dict | str | None") -> "Config":
        if config is None:
            return Config()
        if isinstance(config, Config):
            return config
        if isinstance(config, str):
            return Config.from_file(config)
        if isinstance(config, dict):
            return Config.from_dict(config)
        raise ConfigError(f"cannot load config from {type(config)}")
