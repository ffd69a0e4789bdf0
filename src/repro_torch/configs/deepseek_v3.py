"""DeepSeek-V3 — the paper's reference model [arXiv:2412.19437, paper Table 1].

671B total / ~37B active; 61 layers, MLA (d_c=512, d_cq=1536), 256 routed
experts top-8 + 1 shared, first 3 layers dense FFN (h_F=18432).  Same
values as the reference package's ``configs/deepseek_v3.py``.
"""

from repro_torch.core.notation import (AttentionKind, FamilyKind, MLASpec,
                                       MlpKind, MoESpec, ModelSpec)

SPEC = ModelSpec(
    name="deepseek-v3",
    family=FamilyKind.MOE,
    n_layers=61,
    h=7168,
    n_h=128,
    n_kv=128,
    d_head=128,
    h_ff=18432,
    vocab=129280,
    attention=AttentionKind.MLA,
    mlp=MlpKind.SWIGLU,
    mla=MLASpec(d_cq=1536, d_c=512, d_h=128, d_hr=64, d_v=128),
    moe=MoESpec(n_routed=256, n_active=8, n_shared=1, d_ff_expert=2048,
                first_k_dense=3),
    rope_theta=10000.0,
    max_seq_len=4096,
    notes="paper reference config (Table 1)",
)

SMOKE = ModelSpec(
    name="deepseek-v3-smoke",
    family=FamilyKind.MOE,
    n_layers=2,
    h=256,
    n_h=4,
    n_kv=4,
    d_head=32,
    h_ff=512,
    vocab=512,
    attention=AttentionKind.MLA,
    mlp=MlpKind.SWIGLU,
    mla=MLASpec(d_cq=96, d_c=64, d_h=32, d_hr=16, d_v=32),
    moe=MoESpec(n_routed=4, n_active=2, n_shared=1, d_ff_expert=128,
                first_k_dense=1),
    max_seq_len=512,
)
