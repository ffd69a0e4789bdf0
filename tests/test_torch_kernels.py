"""The port's kernel ops on the CPU against the reference package's Pallas
kernels (interpret mode) and jnp oracles.

On a CPU tensor each ``repro_torch.kernels.ops`` wrapper runs its plain
version, so this holds the plain versions — which the CUDA kernels are held
against on the card by ``chip_smoke.py`` — to the TPU kernels' semantics,
and the ``autograd.Function`` gradients to the reference ``custom_vjp``
gradients.  Inputs are drawn with numpy from a seed and rounded to bf16 the
same way on both sides.  Tolerance: bf16 forward/gradient 5e-2, the
reference suite's own (``tests/test_kernel_equivalence.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import backend as JB  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import backend as TB  # noqa: E402

ATOL = 5e-2


def _bf16_pair(rng, shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a, jnp.bfloat16), torch.tensor(a).to(torch.bfloat16)


def _close(tag, got, want, atol=ATOL):
    got = got.float().detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = want.float().detach().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=atol, rtol=ATOL, err_msg=tag)


@pytest.mark.parametrize("h", [256, 96, 64])
@pytest.mark.parametrize("gemma", [False, True])
def test_rmsnorm_matches_pallas(h, gemma):
    rng = np.random.default_rng(h)
    xj, xt = _bf16_pair(rng, (3, 24, h))
    sj, st = _bf16_pair(rng, (h,), 0.1)
    sj, st = sj + 1, st + 1
    got = tops.rmsnorm(xt, st, eps=1e-6, gemma_style=gemma)
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    _close("vs pallas", got, jops.rmsnorm(xj, sj, eps=1e-6,
                                          gemma_style=gemma))
    _close("vs jnp ref", got, jref.rmsnorm_ref(xj, sj, eps=1e-6,
                                               gemma_style=gemma))

    gj, gt = _bf16_pair(rng, (3, 24, h))
    _, vjp = jax.vjp(lambda x, s: JB._pallas_rmsnorm(1e-6, gemma, x, s),
                     xj, sj)
    dxj, dsj = vjp(gj)
    xt.requires_grad_(True)
    st.requires_grad_(True)
    TB._RMSNormFn.apply(xt, st, 1e-6, gemma).backward(gt)
    _close("dx", xt.grad, dxj)
    _close("dscale", st.grad, dsj)


@pytest.mark.parametrize("s,block", [(40, 16), (32, 128)])
def test_flash_attention_matches_pallas(s, block):
    """dq=48 != dv=32 (the SMOKE MLA widths); s=40 with 16-row tiles makes
    the reference kernel pad a ragged last tile, which the port masks."""
    rng = np.random.default_rng(s)
    b, nh, dq, dv = 2, 4, 48, 32
    scale = dq ** -0.5
    qj, qt = _bf16_pair(rng, (b, s, nh, dq))
    kj, kt = _bf16_pair(rng, (b, s, nh, dq))
    vj, vt = _bf16_pair(rng, (b, s, nh, dv))
    got = tops.flash_attention(qt, kt, vt, scale=scale, causal=True)
    assert got.shape == (b, s, nh, dv)
    _close("vs pallas", got, jops.flash_attention(
        qj, kj, vj, scale=scale, causal=True, block_q=block, block_k=block))
    _close("vs jnp ref", got, jref.flash_attention_ref(qj, kj, vj,
                                                       scale=scale))

    gj, gt = _bf16_pair(rng, (b, s, nh, dv))
    _, vjp = jax.vjp(lambda q, k, v: JB._pallas_attention(scale, q, k, v),
                     qj, kj, vj)
    want = vjp(gj)
    for t in (qt, kt, vt):
        t.requires_grad_(True)
    TB._FlashFn.apply(qt, kt, vt, scale).backward(gt)
    for tag, t, w in zip("qkv", (qt, kt, vt), want):
        _close(f"d{tag}", t.grad, w)


def test_gmm_matches_pallas():
    """C = 40 (the SMOKE capacity at B=2, S=32) is not a multiple of 128,
    so block_m = C: one row block per expert."""
    rng = np.random.default_rng(7)
    E, C, K, N = 4, 40, 64, 32
    lj, lt = _bf16_pair(rng, (E * C, K))
    rj, rt = _bf16_pair(rng, (E, K, N), K ** -0.5)
    emap = np.asarray([2, 0, 3, 1], np.int32)
    got = tops.gmm(lt, rt, torch.from_numpy(emap), block_m=C)
    assert got.shape == (E * C, N) and got.dtype == torch.bfloat16
    _close("vs pallas", got, jops.gmm(lj, rj, jnp.asarray(emap), block_m=C,
                                      block_n=N))
    _close("vs jnp ref", got, jref.gmm_ref(lj, rj, jnp.asarray(emap),
                                           block_m=C))


def test_grouped_mlp_matches_pallas():
    rng = np.random.default_rng(11)
    E, C, h, f = 4, 40, 64, 32
    bufj, buft = _bf16_pair(rng, (E, C, h))
    ws = [_bf16_pair(rng, shape, shape[1] ** -0.5)
          for shape in ((E, h, f), (E, h, f), (E, f, h))]
    assert TB._gmm_block(C) == JB._gmm_block(C) == C
    out_j, vjp = jax.vjp(JB._pallas_grouped_mlp, bufj, *[w[0] for w in ws])
    leaves = [buft] + [w[1] for w in ws]
    for t in leaves:
        t.requires_grad_(True)
    out_t = TB._GroupedMlpFn.apply(*leaves)
    _close("forward", out_t, out_j)
    gj, gt = _bf16_pair(rng, (E, C, h))
    out_t.backward(gt)
    grads_j = vjp(gj)
    _close("dbuf", leaves[0].grad, grads_j[0])
    for i in (1, 2, 3):
        # a weight gradient is a bf16 sum over E*C rows that XLA and
        # PyTorch round at different points: absolute slack of 1% of the
        # gradient's largest entry (about two bf16 ulps there)
        w = np.asarray(grads_j[i], np.float32)
        _close(f"dw{i}", leaves[i].grad, w,
               atol=max(ATOL, 1e-2 * float(np.abs(w).max())))
