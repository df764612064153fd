"""recurrentgemma-2b [hybrid] — Griffin: RG-LRU + local attention, 1:2.

Pattern (rec, rec, local) tiled over 26 layers (8 cycles + 2
remainder rec layers), MQA kv=1 window 2048, lru_width = d_model = 2560,
temporal conv width 4, GeGLU.  [arXiv:2402.19427]
"""
from repro_torch.configs.base import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    layer_pattern=("rec", "rec", "local"),
    window=2048,
    rnn_width=2560,
    conv_width=4,
    rope_theta=1e4,
    mlp_act="gelu",
    norm="rmsnorm",
    norm_eps=1e-6,
    tie_embeddings=True,
    embed_scale=True,
))
