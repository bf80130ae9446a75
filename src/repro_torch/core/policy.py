"""Quantization policy configuration (port of ``repro/core/policy.py``).

A :class:`QuantPolicy` describes how the ALS-PoTQ / MF-MAC scheme is
applied to a model's linear layers.  Field names are the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class KVQuantSpec:
    """Wire-format recipe for PoT-quantized KV cache pages
    (``core/compress.py``: one beta per written token, nearest rounding).

    Attributes:
      bits: PoT bit-width of the codes (1 sign + b-1 exponent bits, b>=3).
      pack: store two codes per byte (signed nibbles along head_dim).
        Requires bits <= 4 (|code| <= 2*emax+1 = 7) and an even head_dim.
    """

    bits: int = 4
    pack: bool = True

    def __post_init__(self) -> None:
        if self.bits < 3:
            raise ValueError(f"KVQuantSpec.bits must be >= 3, got {self.bits}")
        if self.pack and self.bits > 4:
            raise ValueError(
                f"nibble packing requires bits <= 4 (codes must fit a signed "
                f"nibble); got bits={self.bits}"
            )


#: The pinned KV-cache recipe: 4-bit PoT codes, per-token amax scale,
#: nearest rounding, nibble-packed.  Decode under it is bit-identical
#: across page sizes, pool vs solo, and the decode/chunk/verify writes.
KV_PINNED = KVQuantSpec(bits=4, pack=True)


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Paper-faithful defaults: 5-bit PoT on W/A/G, WBC on, PRC on.

    Attributes:
      enabled: master switch.  ``False`` => plain FP32 matmuls.
      bits_w / bits_a / bits_g: PoT bit-widths (1 sign + b-1 exponent bits).
      bits_g_last: bit-width for the last linear layer's activation grads.
      weight_bias_correction: subtract mean(W) before quantization (WBC).
      ratio_clip_init: PRC clipping ratio gamma; ``None`` disables PRC.
      stochastic_rounding: declared by the reference and read nowhere in
        it (its mf_linear rounds to nearest); refused here rather than
        given a meaning the reference lacks.  Stochastic rounding itself
        is ``core.potq.pot_quantize(stochastic=True)`` (the gradient
        compressor, ``core/compress.py``).
      quantize_attention: ALSO run the attention QK^T / PV activation-by-
        activation products through PoT quantization (``mfmac.mf_act_dot``);
        beyond the paper, off for paper-faithful runs.
      use_pallas: kept for field parity with the reference and **ignored
        by the port**.  In the port, dispatch depends only on the device
        of the operands: CUDA tensors always go to the hand-written kernel
        (``kernels/ops.py``), CPU tensors always go to the plain PyTorch
        version.  Both compute the port's numeric spec bit for bit.
      accum_dtype: accumulation dtype of the MF-MAC (float32).
      weights_prequantized: weights already WBC'd + PoT-quantized at load
        (serve/quantized_weights.py), stored as exact PoT values in bf16.
      per_sample_act_scales: forward activation scales per leading-dim
        sample (batch-invariant decode; forced on by the serving engine).
      kv_quant: the :class:`KVQuantSpec` of the serving pool's K/V pages
        (None: bf16 pages); ``PoolEngine(kv_quant=...)`` sets it.
    """

    enabled: bool = True
    bits_w: int = 5
    bits_a: int = 5
    bits_g: int = 5
    bits_g_last: int = 6
    weight_bias_correction: bool = True
    ratio_clip_init: Optional[float] = 0.95
    stochastic_rounding: bool = False
    quantize_attention: bool = False
    use_pallas: bool = False
    accum_dtype: str = "float32"
    weights_prequantized: bool = False
    per_sample_act_scales: bool = False
    kv_quant: Optional[KVQuantSpec] = None

    def __post_init__(self) -> None:
        if self.stochastic_rounding:
            raise NotImplementedError(
                "QuantPolicy.stochastic_rounding: the reference declares this flag and "
                "reads it nowhere (its quantizers round to nearest), so the port refuses "
                "it; stochastic rounding is core.potq.pot_quantize(stochastic=True), "
                "used by core.compress"
            )

    @property
    def prc_enabled(self) -> bool:
        return self.ratio_clip_init is not None

    def bits_for(self, tensor: str, is_last_layer: bool = False) -> int:
        """The PoT bit-width of a weight (``"w"``), an activation (``"a"``)
        or an activation gradient (``"g"``; ``bits_g_last`` into the last
        layer)."""
        if tensor == "w":
            return self.bits_w
        if tensor == "a":
            return self.bits_a
        if tensor == "g":
            return self.bits_g_last if is_last_layer else self.bits_g
        raise ValueError(f"unknown tensor kind {tensor!r}")


def draft_policy(policy: QuantPolicy, bits: int = 3) -> QuantPolicy:
    """The low-bit self-draft policy of a serving policy (serve/spec.py):
    the same weights at ``bits`` PoT bits for W and A.
    ``weights_prequantized`` is cleared, so each draft step re-quantizes
    the served (exact 5-bit PoT) weights down to ``bits`` at use, WBC
    included.  ``kv_quant`` is kept: the draft reads and writes the same
    cache as the verify pass."""
    if not policy.enabled:
        raise ValueError(
            "draft_policy requires a quantized serving policy "
            "(policy.enabled=True); an FP baseline has no cheaper "
            "bit-width to draft at"
        )
    if not 2 <= bits < min(policy.bits_w, policy.bits_a):
        raise ValueError(
            f"draft bits must be in [2, min(bits_w, bits_a)) = "
            f"[2, {min(policy.bits_w, policy.bits_a)}); got {bits}"
        )
    return dataclasses.replace(
        policy, bits_w=bits, bits_a=bits, weights_prequantized=False
    )


#: The paper's scheme (Algorithm 1).
PAPER_FAITHFUL = QuantPolicy()

#: FP32 baseline ("Original" rows of the paper's tables).
FP32_BASELINE = QuantPolicy(enabled=False)

#: Ablation variants for paper Table 5 (the training CLI's ``--policy``).
ABLATION_NO_WBC = dataclasses.replace(PAPER_FAITHFUL, weight_bias_correction=False)
ABLATION_NO_PRC = dataclasses.replace(PAPER_FAITHFUL, ratio_clip_init=None)
