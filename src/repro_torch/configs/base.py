"""Architecture configuration dataclasses (copy of ``repro/configs/base.py``).

The port keeps its own copy: it imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    shared_expert: bool = False  # llama4-style always-on shared expert


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # 'decoder' | 'hybrid' | 'ssm' | 'encdec' | 'vlm'
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    act: str = "swiglu"  # 'swiglu' | 'gelu'
    norm: str = "rms"  # 'rms' | 'ln' | 'nonparam_ln'
    rope_theta: float = 10000.0
    window: Optional[int] = None  # sliding-window attention width
    moe: Optional[MoEConfig] = None
    tie_embeddings: bool = False
    pattern: Optional[Tuple[str, ...]] = None
    lru_width: Optional[int] = None
    conv_width: int = 4
    ssm_state: int = 0
    ssm_chunk: int = 256
    ssm_expand: int = 2
    enc_layers: int = 0
    enc_seq: int = 1500
    frame_dim: int = 0
    num_patches: int = 0
    patch_dim: int = 0
    vocab_pad_multiple: int = 512
    act_dtype: str = "float32"

    @property
    def vocab_padded(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab + m - 1) // m) * m

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this arch run 500k-token contexts?"""
        return self.family in ("ssm", "hybrid") or self.window is not None

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: sequence length and global batch."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shapes_for(cfg: ModelConfig):
    """The shape cells that are well-defined for this arch: a pure
    full-attention arch has no long_500k cell (O(S^2) at 512k)."""
    return tuple(s for s in ALL_SHAPES
                 if s.name != "long_500k" or cfg.subquadratic)
