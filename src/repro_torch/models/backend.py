"""Kernel-backend dispatch: the ONE point where model code picks between the
plain PyTorch math and the hand-written CUDA kernels.

``ModelOptions.backend`` is ``"reference"`` (plain PyTorch) or ``"cuda"``
(the kernels of ``kernels.ops``; the reference package's ``"pallas"``).
Every hot op resolves here: ``rmsnorm`` (ln1/ln2 and MLA's q/kv norms),
``mla_attention`` (dq != dv flash) and the MoE expert FFN
``grouped_mlp``.

Autodiff contract: each kernel op is a ``torch.autograd.Function`` whose
forward runs the kernel wrapper and whose backward re-derives the plain
version's gradient from the saved *inputs*, as the reference's
``_pallas_*_bwd`` do.  Nothing O(s²) is kept between forward and backward;
the score matrix exists only inside one layer's backward.  On a CPU tensor
the wrapper runs the plain version, so the CPU tests drive these same
Functions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as K
from repro_torch.kernels.ref import flash_attention_ref, rmsnorm_ref

BACKENDS = ("reference", "cuda")
# attention impls that run the flash kernel (never materialise the
# resident 5·b·n_h·s² buffers)
FLASH_IMPLS = ("cuda", "flash")


# ---------------------------------------------------------------------------
# Backend / attention-impl resolution
# ---------------------------------------------------------------------------

def resolve_backend(opts) -> str:
    """ModelOptions -> backend name; ``opts=None`` means reference."""
    if opts is None:
        return "reference"
    backend = opts.backend
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; want one of {BACKENDS}")
    return backend


def resolve_attn_impl(opts) -> str:
    """The attention impl a block runs: ``"cuda"`` (the flash kernel) when
    the backend is cuda, else ``opts.attn_impl``.  MLA attention is always
    causal with no window, so the kernel's contract always holds; the
    reference's fallback reasons (non-causal, sliding window) belong to the
    GQA path, which is not ported yet."""
    if resolve_backend(opts) == "cuda":
        return "cuda"
    return opts.attn_impl if opts is not None else "naive"


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

def _plain_vjp(fn, inputs, grad_out):
    """Gradient of the plain version ``fn`` at ``inputs`` against
    ``grad_out``: the backward of every kernel op."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        out = fn(*leaves)
    return torch.autograd.grad(out, leaves, grad_out)


class _RMSNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps, gemma_style):
        ctx.save_for_backward(x, scale)
        ctx.eps, ctx.gemma_style = eps, gemma_style
        return K.rmsnorm(x, scale, eps=eps, gemma_style=gemma_style)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        gx, gs = _plain_vjp(
            lambda x_, s_: rmsnorm_ref(x_, s_, eps=ctx.eps,
                                       gemma_style=ctx.gemma_style),
            (x, scale), g)
        return gx, gs, None, None


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6, *,
            gemma_style: bool = False,
            backend: str = "reference") -> torch.Tensor:
    """Backend-dispatched RMSNorm; same (params, x, eps) signature as
    ``layers.rmsnorm`` so call sites swap in place."""
    if backend == "cuda":
        return _RMSNormFn.apply(x.contiguous(), p.scale, float(eps),
                                bool(gemma_style))
    from .layers import rmsnorm as rmsnorm_plain
    return rmsnorm_plain(p, x, eps, gemma_style=gemma_style)


# ---------------------------------------------------------------------------
# attention (the kernel supports dq != dv)
# ---------------------------------------------------------------------------

class _FlashFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return K.flash_attention(q, k, v, scale=scale, causal=True)

    @staticmethod
    def backward(ctx, g):
        # recompute through the plain version: only q/k/v were saved, so the
        # s² score matrix exists transiently inside this backward
        q, k, v = ctx.saved_tensors
        gq, gk, gv = _plain_vjp(
            lambda q_, k_, v_: flash_attention_ref(q_, k_, v_,
                                                   scale=ctx.scale,
                                                   causal=True),
            (q, k, v), g)
        return gq, gk, gv, None


def mla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float, impl: str = "naive") -> torch.Tensor:
    """Causal MLA context for (b, s, n_h, d) heads, dq = d_h + d_hr and
    dv = d_v.  ``impl``: "cuda"/"flash" run the kernel, whatever the
    backend (as in the reference); "naive" materialises the scores."""
    if impl in FLASH_IMPLS:
        return _FlashFn.apply(q, k, v, float(scale))
    if impl == "chunked":
        raise NotImplementedError("attn_impl='chunked' is not ported yet")
    from .attention import causal_mask, naive_attention
    return naive_attention(q, k, v, causal_mask(q.shape[1], q.device),
                           scale)


# ---------------------------------------------------------------------------
# grouped MLP (the MoE expert FFN over the static-capacity dispatch buffer)
# ---------------------------------------------------------------------------

def _gmm_block(n: int, pref: int = 128) -> int:
    """Row-block size of the grouped GEMM: 128 when it divides the capacity,
    else the whole capacity — the reference's choice, kept so both packages
    group rows the same way."""
    return pref if n % pref == 0 else n


def _grouped_mlp_ref(buf, wg, wu, wd):
    a = F.silu(torch.einsum("ech,ehf->ecf", buf, wg))
    a = a * torch.einsum("ech,ehf->ecf", buf, wu)
    return torch.einsum("ecf,efh->ech", a, wd)


def _grouped_mlp_kernels(buf, wg, wu, wd):
    E, C, h = buf.shape
    bm = _gmm_block(C)
    # rows are pre-grouped C per expert, so the expert map is static
    emap = torch.arange(E, dtype=torch.int32, device=buf.device) \
        .repeat_interleave(C // bm)
    lhs = buf.reshape(E * C, h)
    gate = K.gmm(lhs, wg, emap, block_m=bm)
    up = K.gmm(lhs, wu, emap, block_m=bm)
    a = F.silu(gate) * up
    return K.gmm(a, wd, emap, block_m=bm).reshape(E, C, h)


class _GroupedMlpFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, buf, wg, wu, wd):
        ctx.save_for_backward(buf, wg, wu, wd)
        return _grouped_mlp_kernels(buf, wg, wu, wd)

    @staticmethod
    def backward(ctx, g):
        return _plain_vjp(_grouped_mlp_ref, ctx.saved_tensors, g)


def grouped_mlp(buf, wg, wu, wd, *, backend: str = "reference"):
    """SwiGLU expert FFN batched over the expert dim.

    buf: (E, C, h) dispatch buffer; wg/wu: (E, h, f); wd: (E, f, h).  The
    cuda path runs three grouped GEMMs on the flattened (E·C, h) rows with
    a static expert map."""
    if backend == "cuda":
        return _GroupedMlpFn.apply(buf.contiguous(), wg, wu, wd)
    return _grouped_mlp_ref(buf, wg, wu, wd)
