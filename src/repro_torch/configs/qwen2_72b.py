"""qwen2-72b [dense] — GQA kv=8, QKV bias.  [arXiv:2407.10671]"""
from repro_torch.configs.base import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    layer_pattern=("global",),
    attn_bias=True,
    rope_theta=1e6,
    mlp_act="silu",
    norm="rmsnorm",
    norm_eps=1e-6,
))
