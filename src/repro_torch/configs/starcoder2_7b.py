"""starcoder2-7b — dense, GQA kv=4, RoPE. [arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="decoder",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    kv_heads=4,
    d_ff=18432,
    vocab=49152,
    head_dim=128,
    act="gelu",
    norm="ln",
    rope_theta=100000.0,
)
