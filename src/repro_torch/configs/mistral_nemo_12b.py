"""mistral-nemo-12b — dense GQA, 128k ctx.
[hf:mistralai/Mistral-Nemo-Base-2407; hf]

long_500k runs a sliding-window (4096) variant (``config_for_shape``);
other shapes use full attention as published.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="decoder",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    kv_heads=8,
    d_ff=14336,
    vocab=131072,
    head_dim=128,
    act="swiglu",
    norm="rms",
    rope_theta=1000000.0,
)

LONG_CONTEXT_WINDOW = 4096
