"""ModelConfig of the PyTorch port: a copy of the reference package's schema
(``repro/configs/base.py``), so that a configuration reads the same in both.

A model is a stack of *segments*; each segment is ``count`` repetitions of a
*layer pattern* (tuple of block kinds).  Block kinds: ``attn`` (GQA/MQA/MHA),
``mla`` (DeepSeek latent attention), ``ssm`` (Mamba-2 SSD), ``rglru``
(Griffin RG-LRU), ``local`` (sliding-window attention).  Each block is
followed by its FFN (dense GLU or MoE) according to the config.

The port serves the dense attention family (``attn`` blocks with a dense
FFN); the other kinds and sub-configs stay in the schema so that it reads
whole, and :mod:`repro_torch.models.transformer` raises on what it does not
serve yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0  # routed experts (0 = dense model)
    top_k: int = 1
    n_shared: int = 0  # always-on shared experts
    d_ff_expert: int = 0  # per-expert hidden size
    capacity_factor: float = 1.25
    min_capacity: int = 8
    router_aux_coef: float = 0.001  # load-balance auxiliary loss
    router_dtype: str = "float32"
    # which layers are MoE: every `every`-th layer starting at `first`
    first_moe_layer: int = 0
    moe_layer_period: int = 1


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0  # 0 → d_model
    d_conv: int = 4
    c_constant: float = 8.0  # Griffin's fixed `c` in a_t = a^{c·r_t}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell (assigned per architecture)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 → d_model // n_heads

    # layer program: tuple of (pattern, count); pattern is a tuple of block
    # kinds, e.g. (("attn",), 16) or (("rglru","rglru","local"), 12)
    segments: Tuple[Tuple[Tuple[str, ...], int], ...] = ()

    # attention
    rope_theta: float = 10000.0
    partial_rotary: float = 1.0  # fraction of head_dim that rotates
    window: int = 0  # sliding window for "local" blocks
    prefix_len: int = 0  # bidirectional prefix (VLM prefix-LM)
    qk_norm: bool = False
    attn_logit_softcap: float = 0.0

    # ffn
    activation: str = "silu"  # silu (SwiGLU) | gelu (GeGLU)
    ffn_type: str = "glu"  # glu | mlp (plain 2-matrix MLP)
    tie_embeddings: bool = False

    # sub-configs
    moe: MoEConfig = MoEConfig()
    mla: Optional[MLAConfig] = None
    ssm: SSMConfig = SSMConfig()
    rglru: RGLRUConfig = RGLRUConfig()

    # multimodal stubs
    n_prefix_embeds: int = 0  # VLM: # of precomputed patch embeddings
    n_codebooks: int = 0  # audio: EnCodec codebooks (0 = plain tokens)
    n_cond_embeds: int = 0  # audio: conditioning prefix embeddings

    # numerics / training
    norm_eps: float = 1e-6
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    # remat policy: "full" recomputes everything in backward (min memory);
    # "save_dots" keeps matmul outputs (no MXU recompute — trades HBM for
    # the ~4/3 FLOP overhead; §Perf iteration A6)
    remat_policy: str = "full"
    logit_softcap: float = 0.0
    embedding_scale: bool = False  # gemma-style sqrt(d_model) input scaling
    mtp_depth: int = 0  # DeepSeek multi-token-prediction heads

    # which shape cells support sub-quadratic 500k decode
    supports_long_context: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if not self.segments:
            object.__setattr__(self, "segments", ((("attn",), self.n_layers),))
        total = sum(len(p) * c for p, c in self.segments)
        if total != self.n_layers:
            raise ValueError(
                f"{self.name}: segments cover {total} layers != n_layers={self.n_layers}"
            )

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def is_moe_layer(self, layer_idx: int) -> bool:
        m = self.moe
        if m.n_experts == 0:
            return False
        if layer_idx < m.first_moe_layer:
            return False
        return (layer_idx - m.first_moe_layer) % m.moe_layer_period == 0
