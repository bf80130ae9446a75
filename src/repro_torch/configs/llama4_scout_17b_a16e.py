"""llama4-scout-17b-16e — MoE, 16 experts top-1 + shared expert.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="decoder",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    kv_heads=8,
    d_ff=8192,
    vocab=202048,
    head_dim=128,
    act="swiglu",
    norm="rms",
    rope_theta=500000.0,
    moe=MoEConfig(num_experts=16, top_k=1, capacity_factor=1.25, shared_expert=True),
)
