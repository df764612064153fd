"""gemma3-12b [dense] — 5:1 local:global sliding-window, 128k context.

head_dim 256, GeGLU, sandwich (pre+post) norms, qk-norm, sqrt(d) embedding
scale, separate rope theta for local (10k) vs global (1M) layers.
[hf:google/gemma-3-12b-pt family]
"""
from repro_torch.configs.base import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    window=1024,
    qk_norm=True,
    post_norms=True,
    rope_theta=1e6,           # global layers
    rope_theta_local=1e4,     # local layers
    mlp_act="gelu",
    norm="rmsnorm",
    norm_eps=1e-6,
    tie_embeddings=True,
    embed_scale=True,
))
