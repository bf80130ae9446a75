"""internvl2-76b — VLM: InternViT frontend (a stub: precomputed patch
embeddings) + InternLM2-76B-like backbone. [arXiv:2404.16821; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    kv_heads=8,
    d_ff=28672,
    vocab=128256,
    head_dim=128,
    act="swiglu",
    norm="rms",
    rope_theta=1000000.0,
    num_patches=256,
    patch_dim=3200,  # InternViT-6B feature width
)
