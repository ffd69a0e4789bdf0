"""Model-architecture notation (paper Table 1/2).

The port's own copy of the part of the reference ``ModelSpec`` that the
training path reads.  Field names and defaults match the reference so a
spec reads the same in both packages; the SSM/encoder fields and the
parameter-count helpers stay with the reference until a slice needs them.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class AttentionKind(enum.Enum):
    """Which attention mechanism a layer uses."""

    MHA = "mha"            # n_kv == n_h
    GQA = "gqa"            # 1 < n_kv < n_h
    MQA = "mqa"            # n_kv == 1
    MLA = "mla"            # DeepSeek multi-head latent attention
    NONE = "none"          # attention-free (pure SSM)


class MlpKind(enum.Enum):
    SWIGLU = "swiglu"      # gate/up/down, 3 matrices (DeepSeek, Qwen, OLMoE)
    GEGLU = "geglu"        # gate/up/down with GeLU (Gemma)
    GELU = "gelu"          # fc1/fc2, 2 matrices (Whisper)


class FamilyKind(enum.Enum):
    DENSE = "dense"
    MOE = "moe"
    SSM = "ssm"
    HYBRID = "hybrid"      # parallel attention + SSM heads (Hymba)
    AUDIO = "audio"        # encoder-decoder (Whisper)
    VLM = "vlm"            # dense decoder consuming patch embeddings


@dataclasses.dataclass(frozen=True)
class MLASpec:
    """Multi-head latent attention dimensions (paper Table 1)."""

    d_cq: int = 1536       # query compression dim (q_lora_rank)
    d_c: int = 512         # key-value compression dim (kv_lora_rank)
    d_h: int = 128         # qk_nope_head_dim
    d_hr: int = 64         # qk_rope_head_dim
    d_v: int = 128         # v_head_dim


@dataclasses.dataclass(frozen=True)
class MoESpec:
    """Mixture-of-experts dimensions (paper Table 1)."""

    n_routed: int          # N   — routed experts per MoE layer
    n_active: int          # N_r — routed experts per token (top-k)
    n_shared: int = 0      # N_s — shared experts (always-on)
    d_ff_expert: int = 0   # h_E — expert MLP hidden dim
    # layers [0, first_k_dense) use a dense FFN instead of MoE (DeepSeek: 3).
    first_k_dense: int = 0
    router_bias: bool = False


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Structural description of one architecture.

    ``h`` hidden dim, ``h_ff`` dense-MLP hidden (h_F), ``n_h`` heads,
    ``d_head`` head dim, ``n_layers`` (l), ``vocab`` (v).
    """

    name: str
    family: FamilyKind
    n_layers: int
    h: int
    n_h: int
    n_kv: int
    d_head: int
    h_ff: int
    vocab: int
    attention: AttentionKind = AttentionKind.GQA
    mlp: MlpKind = MlpKind.SWIGLU
    mla: Optional[MLASpec] = None
    moe: Optional[MoESpec] = None
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None
    max_seq_len: int = 32768
    notes: str = ""

    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    def moe_layer_indices(self) -> Tuple[int, ...]:
        if not self.is_moe:
            return ()
        return tuple(range(self.moe.first_k_dense, self.n_layers))

    def n_moe_layers(self) -> int:
        return len(self.moe_layer_indices())

    def n_dense_layers(self) -> int:
        return self.n_layers - self.n_moe_layers()
