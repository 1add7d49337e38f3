"""The port's copy of ``ddw_tpu.utils.config``: ``DataCfg``, ``ModelCfg``,
``TrainCfg``, ``TuneCfg``, ``LMCfg``, the ``section.key=value`` overrides
and the environment helpers the benchmark and measurement tools share
(:func:`env_flag`, :func:`require_gpu_or_exit`). ``ddw_tpu``'s ViT and LM
tile-geometry overrides (``DDW_BENCH_VIT_HIDDEN``, ``DDW_BENCH_VIT_HEADS``,
``DDW_BENCH_LM_HEADS``) have no counterpart: a benchmark's widths come from
its configuration files, never from the environment.

Every field keeps the original's name and default, so configs (and a
packaged model's ``package.json``, which stores ``dataclasses.asdict(
model_cfg)``) mean the same in both packages. A field a model cannot honour
is refused by :func:`ddw_tpu_torch.models.registry.build_model` when set,
never silently ignored: ``dw_impl`` other than ``"xla"`` on ConvNeXt (its
7x7 depthwise is not the 3x3 kernel's) and ``lora_rank`` on a model
without adapters.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any


@dataclass
class DataCfg:
    """Dataset + preprocessing config (the reference ``DataCfg``: image
    size, the 50% sample, the 90/10 split with seed 42)."""

    table_root: str = "/tmp/ddw_tpu/tables"
    source_dir: str = ""                # raw JPEG class-dir tree (tf_flowers layout)
    img_height: int = 224
    img_width: int = 224
    channels: int = 3
    sample_fraction: float = 0.5        # reference samples 50% of the raw images
    train_fraction: float = 0.9         # 90/10 split
    split_seed: int = 42                # reference seed
    shard_size: int = 256               # records per shard file in the table store
    shuffle_buffer: int = 1024
    prefetch: int = 2                   # host->device prefetch depth
    loader_workers: int = 4             # decode thread pool

    @property
    def image_shape(self) -> tuple[int, int, int]:
        return (self.img_height, self.img_width, self.channels)


@dataclass
class ModelCfg:
    """Model factory config (the reference's MobileNetV2 transfer model:
    frozen base + GAP -> Dropout(0.5) -> Dense(num_classes) head)."""

    name: str = "mobilenet_v2"          # key into ddw_tpu_torch.models.registry
    num_classes: int = 5
    dropout: float = 0.5
    freeze_base: bool = True            # transfer-learning mode (training only)
    width_mult: float = 1.0
    num_heads: int = 0                  # attention heads (ViT); 0 = default
    hidden: int = 0                     # encoder width (ViT); 0 = default
    pretrained_path: str = ""           # optional converted-weights artifact
    allow_frozen_random: bool = False   # training-side freeze guard opt-in
    bn_momentum: float = 0.9            # BatchNorm running-stat momentum
    dtype: str = "bfloat16"             # compute dtype; params stay f32
    stem_s2d: bool = False              # space-to-depth stem (ops/s2d_conv)
    dw_impl: str = "xla"                # depthwise 3x3: "xla" library grouped
                                        # conv, "pallas" the CUDA kernel at
                                        # stride 1, "pallas_interpret" its
                                        # plain PyTorch version (tests)
    lora_rank: int = 0                  # LoRA (ViT/LM families only)
    lora_alpha: float = 16.0
    lora_targets: tuple[str, ...] = ("query", "value")


@dataclass
class TrainCfg:
    """Training loop + distribution config (the reference's batch 32, Adam
    1e-3; batch per worker, LR x world, 5-epoch warmup, plateau patience 10).
    """

    batch_size: int = 32                # per-worker batch (reference semantics)
    epochs: int = 3
    optimizer: str = "adam"             # adam | adamw | adadelta | sgd
    learning_rate: float = 1e-3
    weight_decay: float = 0.0           # adamw decoupled weight decay
    grad_clip_norm: float = 0.0         # >0: clip grads by global norm
    scale_lr_by_world: bool = True      # Adam(0.001 * hvd.size()) semantics
    warmup_epochs: int = 5              # LearningRateWarmupCallback(warmup_epochs=5)
    plateau_patience: int = 10          # ReduceLROnPlateau(patience=10)
    plateau_factor: float = 0.5
    lr_schedule: str = "plateau"        # "plateau" or "cosine"
    cosine_final_lr_frac: float = 0.0   # cosine floor, fraction of the target LR
    ema_decay: float = 0.0              # >0: Polyak shadow of the params,
                                        # evaluated by the trainer
    early_stop_patience: int = 0        # 0 = disabled
    seed: int = 0
    grad_accum_steps: int = 1           # >1: sequential microbatches per step
    steps_per_dispatch: int = 1         # >1: K steps per chained call over a
                                        # [K, B, ...] super-batch
    moment_dtype: str = "float32"       # "bfloat16": Adam/SGD first moments
    data_axis: str = "data"             # name of the data-parallel axis
    num_devices: int = 0                # 0 = the whole process group
    zero: bool = False                  # ZeRO-1: optimizer moments sharded
                                        # over the data axis (parallel/zero)
    fsdp: bool = False                  # ZeRO-3/FSDP: params and moments
                                        # sharded; exclusive with zero
    pipeline_stages: int = 0            # >0: LMTrainer trains through the
                                        # pipeline step over (data, pipe)
    pipeline_schedule: str = "gpipe"    # "gpipe" | "interleaved"
    pipeline_microbatches: int = 4      # must divide the per-replica batch
    pipeline_virtual_stages: int = 2    # interleaved only: chunks per rank
    checkpoint_dir: str = ""            # "" = no per-epoch checkpoints
    async_checkpoint: bool = False      # write checkpoints on a background thread
    async_checkpoint_inflight: int = 2  # bounded async write queue depth
    checkpoint_every_epochs: int = 1
    checkpoint_keep_best: bool = False  # also keep the best-val_loss state
    log_every_steps: int = 10
    trace_dir: str = ""                 # "" = off; else torch.profiler over
                                        # the first epoch's steps, a Chrome
                                        # trace written into this directory
    debug_cross_host_checks: bool = False  # params checksum into the tracker
    monitor_interval_s: float = 0.0     # >0: sys.* utilization series into
                                        # the run (utils/sysmon, process 0)


@dataclass
class LMCfg:
    """Decoder-only LM config (:class:`ddw_tpu_torch.models.lm.TransformerLM`),
    field for field ``ddw_tpu``'s, so a packaged LM's ``package.json``
    (``dataclasses.asdict(lm_cfg)``) means the same in both packages. MoE
    (``num_experts > 0``) puts :class:`ddw_tpu_torch.models.moe.MoEMlp`
    in every block.
    """

    vocab_size: int = 256
    max_len: int = 2048                 # global sequence length bound
    hidden: int = 256
    depth: int = 4
    num_heads: int = 4
    mlp_dim: int = 1024
    dropout: float = 0.0
    dtype: str = "bfloat16"
    num_experts: int = 0                # >0: MoE MLP blocks
    capacity_factor: float = 1.25       # static expert capacity = cf*k*T/E
    moe_router: str = "top1"            # "top1" (Switch) or "top2" (GShard)
    num_kv_heads: int = 0               # GQA: KV heads (0 = num_heads / MHA)
    lora_rank: int = 0                  # >0: rank-r LoRA adapters on
                                        # lora_targets (models.lora)
    lora_alpha: float = 16.0
    lora_targets: tuple[str, ...] = ("query", "value")
    pos_encoding: str = "learned"       # "learned" absolute table or "rope"
    remat: str = "none"                 # per-block activation remat in
                                        # training: none | full | dots


@dataclass
class TuneCfg:
    """Hyperparameter-search config: ``fmin(max_evals=20,
    SparkTrials(parallelism=4))`` and the sequential distributed mode of the
    reference, field for field ``ddw_tpu``'s."""

    max_evals: int = 20
    parallelism: int = 4                # >1 = parallel trial executor; 1 = sequential
    seed: int = 0
    algo: str = "tpe"                   # tpe | random
    n_startup_trials: int = 5           # random trials before TPE kicks in
    gamma: float = 0.25                 # TPE good/bad split quantile
    prune: bool = False                 # stop hopeless trials early on their
                                        # per-epoch val_loss
    pruner: str = "median"              # "median" or "asha"
    prune_warmup_epochs: int = 1        # median: never prune below this epoch
    prune_min_trials: int = 3           # median: peers needed before trusted
    asha_min_resource: int = 1          # asha: first rung (epochs)
    asha_reduction_factor: int = 3      # asha: eta — top 1/eta survive a rung


_TYPES = {"data": DataCfg, "model": ModelCfg, "train": TrainCfg,
          "tune": TuneCfg, "lm": LMCfg}


def require_gpu_or_exit(verb: str = "measure") -> str:
    """The card's counterpart of ``ddw_tpu``'s ``require_tpu_or_exit``:
    when ``DDW_REQUIRE_GPU`` is set and no CUDA card is visible, print one
    refusal to stderr and exit 4, so a measurement never records CPU
    timings as the card's. Returns the card's name, or ``"cpu"`` where
    there is none."""
    import sys

    import torch

    required = env_flag("DDW_REQUIRE_GPU")      # a typo raises on the card too
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    if required:
        print(f"DDW_REQUIRE_GPU set but torch sees no CUDA card; refusing "
              f"to {verb}", file=sys.stderr)
        sys.exit(4)
    return "cpu"


def env_flag(name: str) -> bool:
    """Boolean environment flag shared by the benchmark and the perf tools.

    Accepts the common spellings both ways; anything else raises — a typo
    must not silently flip a flag in either direction (enabling
    DDW_BENCH_SMOKE degrades measurements; disabling DDW_REQUIRE_GPU records
    CPU timings as the card's)."""
    import os

    val = os.environ.get(name, "").strip().lower()
    if val in ("", "0", "false", "no", "off"):
        return False
    if val in ("1", "true", "yes", "on"):
        return True
    raise ValueError(f"{name} must be a boolean flag "
                     f"(1/true/yes/on or 0/false/no/off), got {val!r}")


def apply_overrides(cfgs: dict[str, Any],
                    overrides: list[str]) -> dict[str, Any]:
    """Apply ``section.key=value`` CLI overrides to a dict of config
    dataclasses. Values parse as JSON when possible, else string."""
    for ov in overrides:
        if "=" not in ov or "." not in ov.split("=", 1)[0]:
            raise ValueError(f"override must look like section.key=value, "
                             f"got {ov!r}")
        path, raw = ov.split("=", 1)
        section, key = path.split(".", 1)
        if section not in cfgs:
            raise KeyError(f"unknown config section {section!r} "
                           f"(have {sorted(cfgs)})")
        cfg = cfgs[section]
        if not hasattr(cfg, key):
            raise KeyError(f"{type(cfg).__name__} has no field {key!r}")
        try:
            val = json.loads(raw)
        except json.JSONDecodeError:
            val = raw
        setattr(cfg, key, val)
    return cfgs


def to_dict(cfg: Any) -> dict[str, Any]:
    """Flatten a dataclass config to a JSON-able dict."""
    return dataclasses.asdict(cfg)


def default_cfgs() -> dict[str, Any]:
    """One default instance of every config section, keyed by its override
    prefix (``data``, ``model``, ``train``, ``tune``, ``lm``)."""
    return {name: typ() for name, typ in _TYPES.items()}
