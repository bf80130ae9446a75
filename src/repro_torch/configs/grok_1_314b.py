"""grok-1-314b — MoE, 8 experts top-2. [hf:xai-org/grok-1; unverified]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="decoder",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    kv_heads=8,
    d_ff=32768,
    vocab=131072,
    head_dim=128,
    act="gelu",
    norm="rms",
    rope_theta=10000.0,
    moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25),
)
