"""Architecture/shape configuration system and registry (the port's copy
of the reference's ``configs/base.py``, field for field).

Every assigned architecture lives in its own ``configs/<id>.py`` holding the
exact published config; ``reduced()`` derives the CPU-smoke-test version of
the same family.  Shapes are the four assigned (seq_len × global_batch)
cells; ``applicable()`` encodes the long_500k sub-quadratic rule.
"""
from __future__ import annotations

import dataclasses
import importlib
import math


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str        # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 → d_model // n_heads
    activation: str = "swiglu"       # swiglu | relu2 | geglu
    qk_norm: bool = False
    rope_theta: float = 10000.0
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- SSM (Mamba-2 SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 128
    conv_kernel: int = 4
    conv_impl: str = "direct"        # direct | fft  (fft → FFTB fft_conv)
    # --- hybrid (RecurrentGemma) ---
    block_pattern: tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    local_window: int = 0
    d_rnn: int = 0                   # RG-LRU width (0 → d_model)
    # --- encoder-decoder (Whisper) ---
    enc_layers: int = 0
    enc_seq: int = 0                 # precomputed frame embeddings (stub)
    # --- VLM (Pixtral) ---
    n_img_tokens: int = 0            # precomputed patch embeddings (stub)
    # --- misc ---
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: str = "full"              # none | full | dots
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))

    # ----------------------------------------------------------- derived
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def param_count(self) -> int:
        """Analytic parameter count (total; for MoE also see active)."""
        D, F, V, L, H, K = (self.d_model, self.d_ff, self.vocab,
                            self.n_layers, self.n_heads, self.n_kv)
        hd = self.head_dim
        emb = V * D * (1 if self.tie_embeddings else 2)
        per = 0
        if self.family == "ssm":
            din, ns, nh = self.d_inner, self.ssm_state, self.ssm_nheads
            per = (D * (2 * din + 2 * ns + nh)      # in_proj (x,z,B,C,dt)
                   + self.conv_kernel * (din + 2 * ns)
                   + din * D + 3 * nh)              # out_proj, A/D/dt_bias
            return emb + L * per + D
        attn = D * H * hd + 2 * D * K * hd + H * hd * D
        glu = self.activation in ("swiglu", "geglu")
        mlp = D * F * (3 if glu else 2)
        if self.family == "moe":
            mlp = self.n_experts * D * self.d_ff * (3 if glu else 2) \
                + D * self.n_experts
        if self.family == "hybrid":
            drnn = self.d_rnn or D
            rec = 2 * D * drnn + drnn * D + self.conv_kernel * drnn \
                + 2 * drnn * drnn + 2 * drnn
            n_attn = sum(1 for i in range(L)
                         if self.block_pattern[i % len(self.block_pattern)]
                         == "attn")
            n_rec = L - n_attn
            return emb + n_attn * (attn + mlp + 2 * D) \
                + n_rec * (rec + mlp + 2 * D) + D
        layers = L * (attn + mlp + 2 * D)
        if self.family == "encdec":
            layers += self.enc_layers * (attn + mlp + 2 * D) \
                + L * (attn + D)            # cross-attn in decoder
        return emb + layers + D

    def active_param_count(self) -> int:
        if self.family != "moe":
            return self.param_count()
        dense_like = dataclasses.replace(
            self, family="dense", d_ff=self.d_ff * self.top_k)
        return dense_like.param_count() + \
            self.n_layers * self.d_model * self.n_experts

    # ------------------------------------------------------------ reduced
    def reduced(self) -> "ArchConfig":
        """Same family, tiny: for CPU smoke tests (fwd + train step)."""
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 2 if not self.block_pattern
                         else len(self.block_pattern)),
            d_model=64,
            n_heads=4,
            n_kv=min(max(self.n_kv, 1), 2) if self.n_kv else 0,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 16),
            ssm_headdim=16 if self.ssm_state else 64,
            ssm_chunk=16,
            local_window=min(self.local_window, 32),
            d_rnn=64 if self.d_rnn else 0,
            enc_layers=min(self.enc_layers, 2),
            enc_seq=min(self.enc_seq, 16),
            n_img_tokens=min(self.n_img_tokens, 8),
            dtype="float32",
            remat="none",
        )


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str            # train | prefill | decode
    seq: int             # sequence length (decode: KV-cache length)
    batch: int           # global batch


SHAPES = {
    "train_4k": Shape("train_4k", "train", 4096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32768, 128),
    "long_500k": Shape("long_500k", "decode", 524288, 1),
}

ARCH_IDS = [
    "qwen3-32b", "tinyllama-1.1b", "nemotron-4-340b", "granite-3-2b",
    "pixtral-12b", "granite-moe-3b-a800m", "dbrx-132b", "whisper-small",
    "recurrentgemma-9b", "mamba2-370m",
]

_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        mod = name.replace("-", "_").replace(".", "_")
        importlib.import_module(f"repro_torch.configs.{mod}")
    return _REGISTRY[name]


def all_configs() -> dict[str, ArchConfig]:
    for a in ARCH_IDS:
        get_config(a)
    return dict(_REGISTRY)


def applicable(cfg: ArchConfig, shape: Shape) -> tuple[bool, str]:
    """Is this (arch × shape) cell runnable-by-design?"""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, ("O(S²) full attention at 524k — long-context decode "
                       "runs only for sub-quadratic (ssm/hybrid) archs")
    return True, ""
