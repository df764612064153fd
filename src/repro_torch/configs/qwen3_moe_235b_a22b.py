"""qwen3-moe-235b-a22b [moe] — 94L, 128 routed experts top-8, GQA kv=4,
QK-RMSNorm, no shared expert.  [hf:Qwen/Qwen3-235B-A22B family]
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,                 # routed expert width (per assignment)
    vocab_size=151936,
    layer_pattern=("moe",),
    qk_norm=True,
    rope_theta=1e6,
    mlp_act="silu",
    norm="rmsnorm",
    norm_eps=1e-6,
    moe=MoEConfig(
        n_experts=128,
        top_k=8,
        d_ff_expert=1536,
        aux_loss_weight=0.001,
    ),
))
