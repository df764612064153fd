"""Architecture configuration: a copy of ``repro/configs/base.py``.

Every architecture is one ``ArchConfig`` in ``configs/<id>.py``, found by
name through ``get_arch``.  ``tiny()`` derives a reduced configuration of
the same family for CPU tests.  The dataclasses are the reference's field
for field, so a configuration reads the same in both packages; the
registry loads the configurations this port has so far (qwen2-1.5b and
deepseek-moe-16b; the other eight wait for the slices that run them).
The shape cells and ``cell_is_runnable`` belong to the dry-run and wait
with it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int            # routed experts
    top_k: int
    d_ff_expert: int
    n_shared: int = 0         # shared (always-on) experts
    d_ff_shared: int = 0      # hidden dim of the shared expert(s)
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.001
    router_jitter: float = 0.0


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads

    # --- block structure -------------------------------------------------
    # cycle of block kinds, tiled over layers; remainder layers unrolled.
    # kinds: "global" (full attn), "local" (sliding window), "rec" (RG-LRU),
    #        "mlstm", "slstm", "moe" (full attn + MoE FFN),
    #        "dense_ffn" (full attn + dense FFN; used inside MoE archs)
    layer_pattern: tuple[str, ...] = ("global",)
    first_k_dense: int = 0            # leading layers forced to "dense_ffn"
    d_ff_dense: int = 0               # their FFN width (deepseek layer 0)
    parallel_block: bool = False      # command-r: attn and FFN in parallel
    post_norms: bool = False          # gemma3 sandwich norms

    # --- attention --------------------------------------------------------
    window: int = 0                   # sliding-window size for "local"
    attn_bias: bool = False           # qwen2 QKV bias
    qk_norm: bool = False             # qwen3 / gemma3 per-head RMSNorm
    rope_theta: float = 1e4
    rope_theta_local: float = 0.0     # gemma3: different theta for local
    attn_softcap: float = 0.0

    # --- mlp / norms / embeddings ------------------------------------------
    mlp_act: str = "silu"             # silu | gelu (both gated: SwiGLU/GeGLU)
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    embed_scale: bool = False         # gemma: scale embeds by sqrt(d_model)
    logit_softcap: float = 0.0

    # --- MoE ----------------------------------------------------------------
    moe: MoEConfig | None = None

    # --- recurrent (RG-LRU / xLSTM) -----------------------------------------
    rnn_width: int = 0                # RG-LRU lru_width (0 -> d_model)
    conv_width: int = 4               # temporal conv in rec/slstm blocks
    mlstm_proj_factor: float = 2.0    # mLSTM block up-projection

    # --- enc-dec / frontends -------------------------------------------------
    is_encdec: bool = False
    n_encoder_layers: int = 0
    frontend: str | None = None       # None | "vision" | "audio"
    n_frontend_tokens: int = 0        # vision: patch count; audio: ignored

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def cycle_len(self) -> int:
        return len(self.layer_pattern)

    def kinds(self) -> list[str]:
        """Resolved per-layer block kinds (length n_layers, decoder stack)."""
        out = []
        for i in range(self.n_layers):
            if i < self.first_k_dense:
                out.append("dense_ffn")
            else:
                j = i - self.first_k_dense
                out.append(self.layer_pattern[j % self.cycle_len])
        return out

    def tiny(self, **overrides) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        changes: dict = dict(
            n_layers=max(2 * self.cycle_len, self.first_k_dense +
                         self.cycle_len),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads <
            self.n_heads else 4,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            d_ff_dense=160 if self.d_ff_dense else 0,
            vocab_size=256,
            window=min(self.window, 16) if self.window else 0,
            rnn_width=64 if self.rnn_width else 0,
            n_frontend_tokens=min(self.n_frontend_tokens, 8),
            n_encoder_layers=2 if self.is_encdec else 0,
        )
        if self.moe is not None:
            # capacity_factor 8: tiny tests are drop-free => deterministic
            changes["moe"] = dataclasses.replace(
                self.moe, n_experts=8, top_k=2, d_ff_expert=32,
                d_ff_shared=64 if self.moe.n_shared else 0,
                capacity_factor=8.0)
        changes.update(overrides)
        return dataclasses.replace(self, name=self.name + "-tiny", **changes)


_REGISTRY: dict[str, ArchConfig] = {}
PORTED = ("qwen2_1_5b", "deepseek_moe_16b")


def register_arch(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    # import the ported config modules once (registration side effect)
    import importlib
    for mod in PORTED:
        importlib.import_module(f"repro_torch.configs.{mod}")
