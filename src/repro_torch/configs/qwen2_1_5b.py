"""qwen2-1.5b [dense] — GQA kv=2, QKV bias, tied embeddings.
[arXiv:2407.10671]
"""
from repro_torch.configs.base import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    layer_pattern=("global",),
    attn_bias=True,
    rope_theta=1e6,
    mlp_act="silu",
    norm="rmsnorm",
    norm_eps=1e-6,
    tie_embeddings=True,
))
