"""The port's DeepSeek-v3 SMOKE model on the CPU against the reference.

Both packages get the same weights (the reference ``Model.init(PRNGKey(0))``
through ``convert.params_from_jax``) and the same batch (the shared numpy
generator, checked token for token).  The port runs ``backend="cuda"``,
whose wrappers take the plain versions for CPU tensors; the reference runs
``backend="pallas"`` (Pallas interpret mode).

* fp32 pins the algorithm: loss within 1e-4 relative, logits within 1e-3.
* bf16 is the working dtype: the bound of ``tests/test_pallas_in_model.py``
  (logits allclose at 0.2 and max diff under 5% of the logit scale), loss
  within 1e-2 relative.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_spec as jget_spec  # noqa: E402
from repro.data.synthetic import config_for, make_batch as jmake_batch  # noqa: E402,E501
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models.moe import moe_forward as jmoe_forward  # noqa: E402
from repro.models.transformer import ModelOptions as JOptions  # noqa: E402
from repro_torch.configs import get_spec  # noqa: E402
from repro_torch.data import SyntheticConfig, make_batch  # noqa: E402
from repro_torch.models import ModelOptions, build_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.moe import (_positions_in_expert, moe_forward,  # noqa: E402,E501
                                    moe_forward_dense_ref)

SPEC = get_spec("deepseek-v3", smoke=True)
JSPEC = jget_spec("deepseek-v3", smoke=True)


@pytest.fixture(autouse=True)
def _fp32_highest():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


def _jax_params(dtype):
    jm = jbuild_model(JSPEC)
    return jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                            dtype=dtype))


def _port_model(tree, dtype, router, backend="cuda"):
    m = build_model(SPEC, ModelOptions(backend=backend, router_impl=router),
                    device="cpu", dtype=dtype)
    return m.load_params(params_from_jax(tree))


def test_batches_match_token_for_token():
    jb = jmake_batch(config_for(JSPEC, 2, 32, seed=3), 5)
    tb = make_batch(SyntheticConfig(2, 32, SPEC.vocab, seed=3), 5, "cpu")
    np.testing.assert_array_equal(np.asarray(jb["tokens"]),
                                  tb["tokens"].numpy())


def test_params_from_jax_names_and_shapes():
    tree = _jax_params(jnp.bfloat16)
    m = _port_model(tree, torch.bfloat16, "softmax")
    got = dict(m.named_parameters())
    assert got["dense_layers.0.attn.w_dq"].shape == (SPEC.h, SPEC.mla.d_cq)
    assert got["moe_layers.0.moe.we_gate"].dtype == torch.bfloat16
    assert got["moe_layers.0.moe.router"].dtype == torch.float32
    np.testing.assert_array_equal(
        got["moe_layers.0.moe.we_down"].detach().float().numpy(),
        np.asarray(tree["moe_layers"]["moe"]["we_down"][0], np.float32))


@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_logits_match_reference(router, dtype):
    tree = _jax_params(getattr(jnp, dtype))
    jm = jbuild_model(JSPEC, JOptions(backend="pallas", router_impl=router))
    batch = jmake_batch(config_for(JSPEC, 2, 32), 0)
    jlogits, _ = jax.jit(jm.forward)(tree, batch)
    jloss, _ = jax.jit(jm.loss)(tree, batch)

    tm = _port_model(tree, getattr(torch, dtype), router)
    tbatch = make_batch(SyntheticConfig(2, 32, SPEC.vocab), 0, "cpu")
    with torch.no_grad():
        tlogits, _ = tm.forward(tbatch)
        tloss, _ = tm.loss(tbatch)
    assert tlogits.dtype == getattr(torch, dtype)

    got, want = tlogits.float().numpy(), np.asarray(jlogits, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    else:
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-2)
        np.testing.assert_allclose(got, want, atol=0.2, rtol=0.2)
        diff = np.abs(got - want).max()
        scale = np.abs(want).max()
        assert diff < 0.05 * max(scale, 1.0), (diff, scale)


@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
def test_moe_layer_matches_reference_fp32(router):
    """One MoE layer alone, default capacity (so some assignments drop):
    the port's dispatch/combine against the reference's, and with capacity
    high enough that nothing drops, against the dropless dense oracle."""
    tree = _jax_params(jnp.float32)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["moe_layers"]["moe"])
    tm = _port_model(tree, torch.float32, router)
    tp = tm.moe_layers[0].moe
    x = np.random.default_rng(1).standard_normal((2, 32, SPEC.h)) \
        .astype(np.float32)
    want = jmoe_forward(jp, JSPEC, jnp.asarray(x), router_impl=router)
    with torch.no_grad():
        got = moe_forward(tp, SPEC, torch.from_numpy(x), router_impl=router,
                          backend="cuda")
        want_y = np.asarray(want.y)
        # expert weights draw with scale E**-0.5 (the reference's fan_in),
        # so outputs reach a few hundred: fp32 slack relative to that
        np.testing.assert_allclose(got.y.numpy(), want_y, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(want_y).max()))
        np.testing.assert_allclose(float(got.aux_loss), float(want.aux_loss),
                                   rtol=1e-5)
        cf = float(SPEC.moe.n_routed)
        dropless = moe_forward(tp, SPEC, torch.from_numpy(x), router_impl=router,
                               capacity_factor=cf, backend="cuda").y
        dense = moe_forward_dense_ref(tp, SPEC, torch.from_numpy(x),
                                      router_impl=router)
        np.testing.assert_allclose(dropless.numpy(), dense.numpy(),
                                   atol=2e-3, rtol=2e-3)


def test_positions_in_expert():
    eids = torch.tensor([2, 0, 2, 1, 0, 2, 2])
    pos, counts = _positions_in_expert(eids, 4)
    assert counts.tolist() == [2, 1, 4, 0]
    assert pos.tolist() == [0, 0, 1, 0, 1, 2, 3]


def test_full_recompute_matches_none():
    """RecomputePolicy.FULL (``torch.utils.checkpoint``) changes what is
    saved, not what is computed: same loss and gradients as NONE."""
    from repro_torch.core import RecomputePolicy
    tree = _jax_params(jnp.float32)
    batch = make_batch(SyntheticConfig(2, 16, SPEC.vocab), 0, "cpu")
    grads = {}
    for policy in (RecomputePolicy.NONE, RecomputePolicy.FULL):
        m = build_model(SPEC, ModelOptions(backend="cuda", recompute=policy),
                        device="cpu", dtype=torch.float32)
        m.load_params(params_from_jax(tree))
        loss, _ = m.loss(batch)
        loss.backward()
        grads[policy] = (loss.item(), {n: p.grad for n, p in
                                       m.named_parameters()})
    (l0, g0), (l1, g1) = grads.values()
    assert l0 == l1
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], rtol=0, atol=0)


@pytest.mark.parametrize("opts", [{"recompute": "SELECTIVE"},
                                  {"recompute": "FULL",
                                   "recompute_fraction": 0.5}])
def test_unported_recompute_raises(opts):
    from repro_torch.core import RecomputePolicy
    kw = dict(opts, recompute=RecomputePolicy[opts["recompute"]])
    m = build_model(SPEC, ModelOptions(**kw), device="cpu").init(0)
    batch = make_batch(SyntheticConfig(2, 16, SPEC.vocab), 0, "cpu")
    with pytest.raises(NotImplementedError):
        m.loss(batch)
