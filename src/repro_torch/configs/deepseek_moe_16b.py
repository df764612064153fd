"""deepseek-moe-16b [moe] — fine-grained MoE: 2 shared + 64 routed top-6.

Layer 0 is a dense FFN (d_ff 10944); layers 1..27 use 64 routed experts of
width 1408 (top-6) plus 2 shared experts of the same width.  MHA kv=16.
[arXiv:2401.06066]
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,                 # routed expert width (per assignment)
    vocab_size=102400,
    layer_pattern=("moe",),
    first_k_dense=1,
    d_ff_dense=10944,
    rope_theta=1e4,
    mlp_act="silu",
    norm="rmsnorm",
    norm_eps=1e-6,
    moe=MoEConfig(
        n_experts=64,
        top_k=6,
        d_ff_expert=1408,
        n_shared=2,
        d_ff_shared=1408,
        aux_loss_weight=0.001,
    ),
))
