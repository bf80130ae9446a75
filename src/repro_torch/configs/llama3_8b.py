"""llama3-8b — dense GQA, 128k vocab. [arXiv:2407.21783; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="decoder",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    kv_heads=8,
    d_ff=14336,
    vocab=128256,
    head_dim=128,
    act="swiglu",
    norm="rms",
    rope_theta=500000.0,
)
