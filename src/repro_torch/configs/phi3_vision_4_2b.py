"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP vision frontend.

Backbone only per the assignment; the vision tower is a STUB whose
precomputed patch embeddings (24x24 = 576 CLIP-L/336 patches) arrive via
``input_specs()`` and are spliced over the first image positions.
[hf:microsoft/Phi-3-vision-128k-instruct]
"""
from repro_torch.configs.base import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,          # MHA
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    layer_pattern=("global",),
    rope_theta=1e4,
    mlp_act="silu",
    norm="rmsnorm",
    norm_eps=1e-5,
    frontend="vision",
    n_frontend_tokens=576,
))
