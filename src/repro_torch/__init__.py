"""PyTorch + CUDA port of the multiplication-free PoT training/serving stack.

Mirrors the layout of the JAX package ``repro`` module for module (the JAX
package stays the numeric reference).  Imports ``torch`` only — never
``jax`` and nothing of ``repro``.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; see :func:`repro_torch.device.resolve_device`.
"""
