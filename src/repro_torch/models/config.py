"""Model/architecture configuration schema for the assigned architecture pool."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

VOCAB_PAD_MULTIPLE = 2048   # pad vocab so 16-way shards stay 128-lane aligned


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # "dense" = Mesh-TF one-hot-matmul dispatch (faithful baseline);
    # "gather" = indexed scatter/gather (§Perf iteration "moe-gather");
    # "sharded" = mesh expert parallelism (must run inside a shard_map —
    # see models.moe.moe_forward_sharded); any other value names a
    # repro.fabric backend ("reference", "pallas", ...) — the layer then
    # routes groups through Fabric.transfer, sharing the shell's
    # interconnect implementation.
    dispatch: str = "dense"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD block parameters."""
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256

    def n_heads(self, d_model: int) -> int:
        return self.expand * d_model // self.head_dim


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma block pattern: `pattern_rec` recurrent blocks followed by
    one local-attention block (1:2 attention:recurrence ratio)."""
    pattern_rec: int = 2
    lru_width: Optional[int] = None
    attn_window: int = 2048


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    attn_window: Optional[int] = None        # SWA window (None = full attention)
    tied_embeddings: bool = False
    rope_theta: float = 10_000.0
    mlp_act: str = "swiglu"                  # swiglu | geglu | gelu
    norm_eps: float = 1e-5
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    n_encoder_layers: int = 0                # enc-dec (whisper): encoder depth
    encoder_len: int = 1500                  # whisper frame count (stubbed)
    n_vision_patches: int = 0                # vlm stub patch count
    dtype: str = "bfloat16"
    # Kernel or plain path for every kernel the model runs: the flash
    # attention of prefill and training, and the crossbar kernels of a
    # fabric-backed MoE ("auto": the kernels on a CUDA device; "torch":
    # the plain versions; JAX's aliases resolve, see fabric.interface).
    kernel_mode: str = "auto"
    # ------------------------------------------------------------------
    remat: str = "dots"                      # nothing | dots | full
    scan_layers: bool = True
    # K/V projection sharding. "tp" shards the Kv*hd dim over the model
    # axis — but with Kv < mesh_model (GQA kv=1..8 vs 16-way TP) that
    # fragments heads across devices and the partitioner inserts resharding
    # around every attention. "replicate" keeps K/V projections replicated
    # over the model axis (they are (d * Kv * hd) — tiny next to wq/wo) so
    # each device holds whole kv heads (§Perf iteration "kv-replicate").
    kv_shard: str = "tp"

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(1, self.n_heads)

    @property
    def vocab_padded(self) -> int:
        return math.ceil(self.vocab / VOCAB_PAD_MULTIPLE) * VOCAB_PAD_MULTIPLE

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode with a bounded-size attention state?"""
        return (self.family in ("ssm", "hybrid")
                or self.attn_window is not None)

    def validate(self) -> None:
        if self.family == "moe":
            assert self.moe is not None
        if self.family == "ssm":
            assert self.ssm is not None
        if self.family == "hybrid":
            assert self.hybrid is not None
        if self.family == "encdec":
            assert self.n_encoder_layers > 0
        if self.n_heads and self.n_kv_heads:
            assert self.n_heads % self.n_kv_heads == 0, "GQA group size"


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell: what the dry-run lowers."""
    name: str                      # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


LM_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)


def shapes_for(cfg: ModelConfig) -> Tuple[ShapeConfig, ...]:
    """The assigned shape set, with the mandated skips applied.

    ``long_500k`` requires sub-quadratic attention; pure full-attention archs
    skip it (recorded in the roofline table as a skip, per DESIGN.md §5).
    """
    out = []
    for s in LM_SHAPES:
        if s.name == "long_500k" and not cfg.sub_quadratic:
            continue
        out.append(s)
    return tuple(out)


def skipped_shapes_for(cfg: ModelConfig) -> Tuple[ShapeConfig, ...]:
    return tuple(s for s in LM_SHAPES if s not in shapes_for(cfg))
