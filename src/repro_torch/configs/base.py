"""Config system: one frozen dataclass describes every supported architecture.

A copy of ``repro/configs/base.py`` (pure Python, so the port carries its
own rather than importing the JAX package).  Every assigned architecture
gets a module in this package exporting CONFIG;
``repro_torch.configs.get_config(arch_id)`` resolves it.  ``reduced()``
produces the CPU-smoke variant (2 layers, d_model<=512, <=4 experts) of the
same family.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Tuple

_VOCAB_PAD_MULTIPLE = 256


def pad_vocab(v: int, multiple: int = _VOCAB_PAD_MULTIPLE) -> int:
    """Megatron-style vocab padding so the table shards over the model axis."""
    return ((v + multiple - 1) // multiple) * multiple


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    citation: str = ""
    # trunk
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 512
    vocab_size: int = 1024
    # attention
    attn_free: bool = False        # rwkv6: no attention at all
    causal: bool = True            # False for encoder-only (hubert)
    qkv_bias: bool = False         # qwen2
    sliding_window: int = 0        # >0 enables windowed attention (long ctx)
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE [t, h, w] halves
    # moe
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0              # per-expert FFN width (granite: 512)
    router_aux_coef: float = 0.01  # load-balance loss coefficient
    # ssm / hybrid
    ssm_state: int = 0             # mamba state size N (hymba: 16)
    ssm_expand: int = 2            # mamba inner expansion
    ssm_conv: int = 4              # mamba depthwise conv width
    # modality frontends (stub carve-out)
    num_patches: int = 0           # vlm: patch-embedding stand-ins per sample
    frontend_stub: bool = False    # audio/vlm: input_specs provides embeddings
    # numerics / misc
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"        # activation/compute dtype
    param_dtype: str = "float32"   # parameter storage dtype

    # ---- derived ----------------------------------------------------------
    @property
    def vocab_padded(self) -> int:
        return pad_vocab(self.vocab_size)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def is_subquadratic(self) -> bool:
        """True if decode with 500k context needs no quadratic attention."""
        return (self.attn_free or self.family in ("ssm", "hybrid")
                or self.sliding_window > 0)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def with_sliding_window(self, window: int = 8192) -> "ModelConfig":
        """First-class long-context variant for dense archs (DESIGN.md §5)."""
        return self.replace(sliding_window=window)

    # ---- parameter counting (used for roofline MODEL_FLOPS = 6·N·D) ------
    def param_count(self, active_only: bool = False) -> int:
        d, L = self.d_model, self.num_layers
        n = self.vocab_padded * d                      # embeddings
        if not self.tie_embeddings:
            n += self.vocab_padded * d                 # lm head
        per_layer = 0
        if not self.attn_free:
            per_layer += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.qkv_bias:
                per_layer += self.q_dim + 2 * self.kv_dim
        if self.family == "ssm":                       # rwkv6 mixer
            H = d // self.head_dim
            per_layer += 4 * d * d + d * d             # r,k,v,g,o
            per_layer += H * self.head_dim             # decay params (approx)
        if self.family == "hybrid" and self.ssm_state:
            di = self.d_inner
            per_layer += d * 2 * di + di * d           # in/out proj
            per_layer += di * (2 * self.ssm_state + 1) # B,C,dt projections
        if self.num_experts:
            e = self.experts_per_token if active_only else self.num_experts
            ff = self.moe_d_ff or self.d_ff
            per_layer += e * (3 * d * ff)
            per_layer += d * self.num_experts          # router
        else:
            per_layer += 3 * d * self.d_ff             # swiglu
        per_layer += 2 * d                             # norms
        n += L * per_layer + d                         # final norm
        return n

    def reduced(self) -> "ModelConfig":
        """CPU smoke variant: same family/code path, tiny dims."""
        d = min(self.d_model, 256)
        hd = 32
        sections = self.mrope_sections
        if sections:
            # rescale (t,h,w) sections to the reduced head_dim/2
            half = hd // 2
            t = max(1, half - 2 * (half * sections[1] // sum(sections)))
            hw = (half - t) // 2
            sections = (half - 2 * hw, hw, hw)
        heads = max(2, min(4, self.num_heads))
        kv = max(1, min(heads, self.num_kv_heads
                        if self.num_kv_heads < self.num_heads else heads))
        return self.replace(
            num_layers=2,
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            experts_per_token=min(self.experts_per_token, 2) if self.num_experts else 0,
            moe_d_ff=min(self.moe_d_ff, 128) if self.moe_d_ff else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            mrope_sections=sections,
            num_patches=min(self.num_patches, 16) if self.num_patches else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            dtype="float32",
            param_dtype="float32",
        )


ARCH_IDS = (
    "hymba-1.5b",
    "deepseek-67b",
    "rwkv6-7b",
    "qwen2-72b",
    "qwen2-vl-2b",
    "llama4-maverick-400b-a17b",
    "llama3.2-1b",
    "llama3-405b",
    "granite-moe-3b-a800m",
    "hubert-xlarge",
)

_MODULE_FOR = {
    "hymba-1.5b": "hymba_1_5b",
    "deepseek-67b": "deepseek_67b",
    "rwkv6-7b": "rwkv6_7b",
    "qwen2-72b": "qwen2_72b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "llama3.2-1b": "llama3_2_1b",
    "llama3-405b": "llama3_405b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "hubert-xlarge": "hubert_xlarge",
    "paper-cnn": "paper_cnn",
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULE_FOR:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULE_FOR)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_MODULE_FOR[arch_id]}")
    return mod.CONFIG


def tuned_opts(cfg: ModelConfig, shape_kind: str) -> dict:
    """Per-arch production defaults distilled from the §Perf hillclimbs
    (EXPERIMENTS.md): MoE dispatch strategy is per-arch, and training runs
    dots-remat with bf16 AdamW moments (fits llama3-405b in v5e HBM with a
    −12% memory / −26% compute term vs full remat)."""
    opts: dict = {}
    if cfg.num_experts:
        # fine-grained small experts (granite: 512-wide, top-8) win with the
        # dense all-expert einsum + fused combine (124x collective cut);
        # large top-1 expert pools (llama4: 128e) need capacity scatter
        # (dense measured 100x worse there).
        ff = cfg.moe_d_ff or cfg.d_ff
        opts["moe_dispatch"] = "dense" if (ff <= 1024 and
                                           cfg.experts_per_token >= 4) else "scatter"
    if shape_kind == "train":
        opts["remat"] = "dots"
        opts["adam_bf16_moments"] = True
    return opts


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
