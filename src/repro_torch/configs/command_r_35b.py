"""command-r-35b [dense] — GQA kv=8, no bias, parallel attn+FFN block,
tied embeddings.  [hf:CohereForAI/c4ai-command-r-v01]
"""
from repro_torch.configs.base import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    layer_pattern=("global",),
    parallel_block=True,
    rope_theta=8e6,
    mlp_act="silu",
    norm="layernorm",
    norm_eps=1e-5,
    tie_embeddings=True,
))
