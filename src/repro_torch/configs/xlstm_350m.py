"""xlstm-350m [ssm] — alternating mLSTM (matrix memory) and sLSTM blocks.

Pattern (mlstm, mlstm, mlstm, slstm) over 24 layers; d_ff=0 (both block
kinds carry internal up/down projections instead of a separate FFN);
mLSTM projection factor 2.  [arXiv:2405.04517]
"""
from repro_torch.configs.base import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50304,
    layer_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    conv_width=4,
    mlstm_proj_factor=2.0,
    norm="layernorm",
    norm_eps=1e-5,
    tie_embeddings=True,
))
