"""olmo-1b — dense MHA, non-parametric LN. [arXiv:2402.00838; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="decoder",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    kv_heads=16,
    d_ff=8192,
    vocab=50304,
    head_dim=128,
    act="swiglu",
    norm="nonparam_ln",
    rope_theta=10000.0,
)
