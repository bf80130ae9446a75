"""mamba2-2.7b — attention-free SSD (state-space duality).
[arXiv:2405.21060; hf:state-spaces/mamba2-2.7b]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_chunk=256,
    ssm_expand=2,
)
