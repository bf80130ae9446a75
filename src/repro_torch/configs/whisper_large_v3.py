"""whisper-large-v3 — encoder-decoder; the conv/mel frontend is a stub
(precomputed frame embeddings). 32 encoder + 32 decoder layers.
[arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,       # decoder layers
    enc_layers=32,     # encoder layers
    d_model=1280,
    n_heads=20,
    kv_heads=20,
    d_ff=5120,
    vocab=51866,
    head_dim=64,
    act="gelu",
    norm="ln",
    rope_theta=10000.0,
    enc_seq=1500,
    frame_dim=128,  # stub frontend feature width
)
