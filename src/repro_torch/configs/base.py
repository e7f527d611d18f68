"""Configs: a copy of ``repro.configs.base``'s ``ModelConfig``,
``MeCeFOConfig``, ``ParallelConfig``, ``ShapeConfig``, ``SHAPES``,
``shape_applicable``, ``TrainConfig``, ``reduced``, ``register`` and
``get_config``.

The port runs the mesh axes ``pod``, ``data`` and ``model``
(``launch/mesh.py``); :meth:`ParallelConfig.check` refuses batch axes and
a tensor-parallel axis of other names.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN replacing the dense FFN on selected layers."""

    n_experts: int = 128
    top_k: int = 8
    d_ff_expert: int = 768
    every: int = 1
    offset: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 1e-2


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) mixer config."""

    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    d_conv: int = 4
    chunk: int = 256


@dataclass(frozen=True)
class MeCeFOConfig:
    """The paper's technique knobs."""

    # "off" | "static" | "dynamic"
    mode: str = "off"
    # Low-rank Wgrad rank r and SVD refresh period tau (paper: tau=100).
    rank: int = 64
    svd_period: int = 100
    # technique II: FFN recompute on degraded layers
    recompute_ffn: bool = True
    # technique I: MHA backward skip on degraded layers
    skip_mha_backward: bool = True
    # technique III: low-rank Wgrad on degraded layers
    lowrank_wgrad: bool = True
    # all-reduce the factored (r x m) gradient instead of the (n x m) one
    lowrank_sync: bool = False


@dataclass(frozen=True)
class ParallelConfig:
    """Mesh + sharding policy (the JAX package's fields and defaults)."""

    # Axis names; the leading axes shard the batch ("dp-like"), the last
    # shards weights ("tp-like").
    dp_axes: Tuple[str, ...] = ("data",)
    tp_axis: str = "model"
    # FSDP: additionally shard weights and optimizer moments over "data".
    fsdp: bool = True
    # "tp_fsdp" (TP over 'model' + FSDP over 'data') or "fsdp" (pure 2-D
    # FSDP over both axes)
    sharding_mode: str = "tp_fsdp"
    # Sequence parallelism over the tp axis.
    sequence_parallel: bool = False
    # Kept for the reference's field set: the port's step takes its remat
    # from ``ExecFlags`` and its trunk is always a loop over periods.
    remat: str = "full"
    scan_layers: bool = True
    # Gradient-accumulation microbatches per optimizer step (1 = off).
    accum: int = 1
    # Gradient compression: "none", "bf16" (each micro-gradient rounded to
    # bf16 before the f32 sum), or the collective schemes "int8" and
    # "lowrank" (``core/grad_sync.py:compress_psum``, MeCeFO's
    # ``lowrank_sync``)
    grad_compression: str = "none"

    def check(self, mesh_shape: dict, cfg: Optional["ModelConfig"] = None) -> None:
        """Raise for what the port does not run on a mesh of ``mesh_shape``
        ({axis: size}): axes other than ``pod``, ``data`` and ``model``,
        batch axes other than ``data`` (with ``pod`` before it) and a
        tensor-parallel axis other than ``model``.  Every model family of
        ``cfg``'s runs on all three."""
        if self.sharding_mode not in ("tp_fsdp", "fsdp"):
            raise ValueError(f"sharding_mode {self.sharding_mode!r}")
        if tuple(self.dp_axes) not in (("data",), ("pod", "data")):
            raise NotImplementedError(f"dp_axes {self.dp_axes}: the port runs ('data',) "
                                      "and ('pod', 'data')")
        if self.tp_axis != "model":
            raise NotImplementedError(f"tp_axis {self.tp_axis!r}: the port runs 'model'")
        other = set(mesh_shape) - {"pod", "data", "model"}
        if other:
            raise NotImplementedError(f"mesh axes {sorted(other)}: the port runs 'pod', "
                                      "'data' and 'model'")


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0  # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 32000
    max_seq_len: int = 1 << 20
    ffn_act: str = "swiglu"
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    attn_every: int = 1
    attn_offset: int = 0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    frontend: Optional[str] = None
    n_patches: int = 576

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded for TP divisibility (only when needed)."""
        if self.vocab_size % 16 == 0:
            return self.vocab_size
        return ((self.vocab_size + 127) // 128) * 128

    def layer_kind(self, layer_idx: int) -> str:
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid":
            return "attn" if layer_idx % self.attn_every == self.attn_offset else "ssm"
        return "attn"

    def layer_is_moe(self, layer_idx: int) -> bool:
        if self.moe is None:
            return False
        return layer_idx % self.moe.every == self.moe.offset

    @property
    def block_period(self) -> int:
        """Smallest period after which the layer pattern repeats."""
        p = self.attn_every if self.family == "hybrid" else 1
        if self.moe is not None:
            p = math.lcm(p, self.moe.every)
        return p


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a (arch x shape) cell is runnable; else the documented reason."""
    if shape.name == "long_500k" and model.family not in ("ssm", "hybrid"):
        return False, (
            "long_500k requires sub-quadratic attention; "
            f"{model.name} is pure full-attention (skip per DESIGN.md)"
        )
    return True, ""


@dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    learning_rate: float = 3e-4
    warmup_frac: float = 0.1
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    optimizer: str = "adamw"  # adamw | sgdm (the paper's theory optimizer)
    momentum: float = 0.9
    grad_clip: float = 1.0
    seed: int = 0
    microbatch: int = 0  # 0 -> no grad accumulation
    checkpoint_every: int = 0  # 0 -> disabled
    checkpoint_dir: str = "/tmp/repro_ckpt"


def reduced(model: ModelConfig, **overrides) -> ModelConfig:
    """A smoke-test-sized config of the same family (same code path)."""
    small = dict(
        n_layers=min(model.n_layers, model.block_period * 2),
        d_model=128,
        n_heads=4,
        n_kv_heads=max(1, min(model.n_kv_heads, 4) if model.n_kv_heads else 4),
        head_dim=32 if model.head_dim else 0,
        d_ff=256,
        vocab_size=512,
        n_patches=8,
    )
    if model.moe is not None:
        small["moe"] = dataclasses.replace(
            model.moe, n_experts=8, top_k=2, d_ff_expert=64
        )
    if model.ssm is not None:
        small["ssm"] = dataclasses.replace(
            model.ssm, d_state=16, head_dim=16, chunk=32
        )
    small.update(overrides)
    return dataclasses.replace(model, **small)


_REGISTRY = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def _load_all() -> None:
    # import every config module for its registration side effect
    from repro_torch.configs import (  # noqa: F401
        glm4_9b,
        granite_34b,
        jamba_1_5_large,
        llama_paper,
        mamba2_2_7b,
        musicgen_medium,
        nemotron_4_340b,
        phi_3_vision_4_2b,
        qwen3_0_6b,
        qwen3_moe_30b_a3b,
        qwen3_moe_235b_a22b,
    )
