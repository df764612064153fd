"""seamless-m4t-large-v2 [audio] — encoder-decoder transformer backbone.

Backbone only per the assignment: the speech frontend is a STUB and
``input_specs()`` provides precomputed audio frame embeddings for the
24-layer encoder; the 24-layer decoder cross-attends to encoder memory.
MHA kv=16, GELU FFN with bias, layernorm.  [arXiv:2308.11596]
"""
from repro_torch.configs.base import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,              # decoder layers
    n_encoder_layers=24,
    is_encdec=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    layer_pattern=("global",),
    attn_bias=True,
    rope_theta=1e4,
    mlp_act="gelu",
    norm="layernorm",
    norm_eps=1e-5,
    frontend="audio",
))
