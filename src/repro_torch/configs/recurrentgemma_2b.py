"""recurrentgemma-2b — RG-LRU + local attention, pattern 1:2.
[arXiv:2402.19427; hf:google/recurrentgemma-2b]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    kv_heads=1,
    d_ff=7680,
    vocab=256000,
    head_dim=256,
    act="gelu",
    norm="rms",
    rope_theta=10000.0,
    window=2048,  # local attention width
    pattern=("rglru", "rglru", "attn"),
    lru_width=2560,
    conv_width=4,
)
