"""Quantization policy configuration (port of ``repro/core/policy.py``).

A :class:`QuantPolicy` describes how the ALS-PoTQ / MF-MAC scheme is
applied to a model's linear layers.  Field names are the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Paper-faithful defaults: 5-bit PoT on W/A/G, WBC on, PRC on.

    Attributes:
      enabled: master switch.  ``False`` => plain FP32 matmuls.
      bits_w / bits_a / bits_g: PoT bit-widths (1 sign + b-1 exponent bits).
      bits_g_last: bit-width for the last linear layer's activation grads.
      weight_bias_correction: subtract mean(W) before quantization (WBC).
      ratio_clip_init: PRC clipping ratio gamma; ``None`` disables PRC.
      stochastic_rounding: not ported yet; must be False.
      quantize_attention: not ported yet; must be False.
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
      kv_quant: quantized KV pages — not ported yet; must be None.
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
    kv_quant: Optional[Any] = None

    def __post_init__(self) -> None:
        unported = {
            "stochastic_rounding": self.stochastic_rounding,
            "quantize_attention": self.quantize_attention,
            "kv_quant": self.kv_quant is not None,
        }
        on = [k for k, v in unported.items() if v]
        if on:
            raise NotImplementedError(
                f"QuantPolicy options not ported to repro_torch yet: {on}"
            )

    @property
    def prc_enabled(self) -> bool:
        return self.ratio_clip_init is not None


#: The paper's scheme (Algorithm 1).
PAPER_FAITHFUL = QuantPolicy()

#: FP32 baseline ("Original" rows of the paper's tables).
FP32_BASELINE = QuantPolicy(enabled=False)

#: Ablation variants for paper Table 5 (the training CLI's ``--policy``).
ABLATION_NO_WBC = dataclasses.replace(PAPER_FAITHFUL, weight_bias_correction=False)
ABLATION_NO_PRC = dataclasses.replace(PAPER_FAITHFUL, ratio_clip_init=None)
