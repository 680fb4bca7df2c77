"""Model configuration dataclass and the architecture registry.

A copy of ``repro/configs/base.py`` (the port imports nothing of the
reference package): every architecture module defines ``CONFIG`` (the
published config) and ``REDUCED`` (a tiny same-family config for CPU
tests). The port carries every architecture of the reference's registry
and runs all seven families; ``check_family`` raises, naming the family,
for a config of any other. ``SHAPES`` and ``cell_is_applicable`` are the
dry-run census's input shapes and its skip rule
(``repro_torch.launch.dryrun``).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A single declarative config covering all assigned LM families."""

    arch_id: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm

    n_layers: int
    d_model: int
    n_heads: int          # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab_size: int       # logical vocab (padded internally; see vocab_padded)

    head_dim: int = 0     # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    moe_top_k: int = 0
    n_shared_experts: int = 0
    n_dense_layers: int = 0          # leading dense-FFN layers (e.g. kimi-k2)
    capacity_factor: float = 1.25

    # --- SSM (mamba-2 SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # --- hybrid (hymba) ---
    attn_window: int = 0             # 0 -> full attention
    global_layers: Tuple[int, ...] = ()
    meta_tokens: int = 0

    # --- encoder-decoder (whisper) ---
    enc_layers: int = 0
    enc_frames: int = 0              # encoder input length (frame embeddings)

    # --- vlm stub ---
    vision_tokens: int = 0           # precomputed patch-embedding slots

    # --- numerics / runtime ---
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True

    # citation string from the assignment table
    source: str = ""

    # ---------------------------------------------------------------- utils
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def vocab_padded(self) -> int:
        # the reference pads to 128 lanes; kept so weights carry as a copy
        return _round_up(self.vocab_size, 128)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell."""
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """The reference's analytic parameter count (its audio family's
        feed-forwards counted as SwiGLU ones, without biases, as the
        reference counts them)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_padded
        hd = self.resolved_head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        dense_ffn = 3 * d * f  # SwiGLU
        per_layer = 2 * d  # norms
        # in_proj (z, x, B, C, dt) + conv + out_proj + A, D
        di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
        ssm = d * (2 * di + 2 * ns + nh) + (di + 2 * ns) * self.ssm_conv \
            + di * d + 2 * nh
        if self.family == "moe":
            n_moe = self.n_layers - self.n_dense_layers
            moe_layer = attn + (self.n_experts + self.n_shared_experts) \
                * dense_ffn + d * self.n_experts
            total = n_moe * (moe_layer + per_layer) \
                + self.n_dense_layers * (attn + dense_ffn + per_layer)
        elif self.family == "ssm":
            total = self.n_layers * (ssm + per_layer)
        elif self.family == "hybrid":
            total = self.n_layers * (attn + ssm + dense_ffn + per_layer) \
                + self.meta_tokens * d
        else:
            total = self.n_layers * (attn + dense_ffn + per_layer)
        if self.enc_layers:   # the encoder's blocks and the cross-attention
            total += self.enc_layers * (attn + dense_ffn + per_layer) \
                + self.n_layers * attn
        return int(total + v * d * (1 if self.tie_embeddings else 2))

    def active_param_count(self) -> int:
        """Parameters a token passes through (MoE: only its routed
        experts count)."""
        if self.family != "moe":
            return self.param_count()
        inactive = (self.n_experts - self.moe_top_k) * 3 * self.d_model \
            * self.d_ff
        return int(self.param_count()
                   - (self.n_layers - self.n_dense_layers) * inactive)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


# the dry-run census's input shapes (repro/configs/base.py SHAPES)
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


# the reference's architectures (repro/configs/base.py ARCH_IDS) and their
# families, each of which the port runs
FAMILIES = {
    "internvl2_76b": "vlm",
    "tinyllama_1_1b": "dense",
    "command_r_plus_104b": "dense",
    "stablelm_1_6b": "dense",
    "qwen1_5_4b": "dense",
    "whisper_small": "audio",
    "dbrx_132b": "moe",
    "kimi_k2_1t_a32b": "moe",
    "mamba2_370m": "ssm",
    "hymba_1_5b": "hybrid",
}
ARCH_IDS = tuple(FAMILIES)
PORTED_FAMILIES = tuple(dict.fromkeys(FAMILIES.values()))

# canonical ids as given in the assignment (hyphenated) -> module names
_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
_ALIASES.update({
    "internvl2-76b": "internvl2_76b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "command-r-plus-104b": "command_r_plus_104b",
    "stablelm-1.6b": "stablelm_1_6b",
    "qwen1.5-4b": "qwen1_5_4b",
    "whisper-small": "whisper_small",
    "dbrx-132b": "dbrx_132b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "mamba2-370m": "mamba2_370m",
    "hymba-1.5b": "hymba_1_5b",
})


def normalize_arch(arch_id: str) -> str:
    key = arch_id.strip()
    if key in ARCH_IDS:
        return key
    if key in _ALIASES:
        return _ALIASES[key]
    raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ALIASES)}")


def check_family(cfg: ModelConfig) -> None:
    """Raise, naming the family, unless the port runs ``cfg``'s family."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.arch_id}: the port runs no {cfg.family!r} family "
            f"(it runs {', '.join(PORTED_FAMILIES)})")


def get_config(arch_id: str, reduced: bool = False) -> ModelConfig:
    mod = importlib.import_module(
        f"repro_torch.configs.{normalize_arch(arch_id)}")
    return mod.REDUCED if reduced else mod.CONFIG


def cell_is_applicable(cfg: ModelConfig, shape: ShapeConfig
                       ) -> Tuple[bool, str]:
    """Whether a (arch x shape) dry-run cell runs, else the skip reason."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "SKIP(full-attention: 500k dense-KV decode is quadratic)"
    return True, ""
