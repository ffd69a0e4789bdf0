"""The port's optimizer and training step against the reference on the CPU.

``adamw_update`` alone, on the same numpy-seeded state and grads (first
step, a later step, clipped and unclipped grads): the fp32 update
``master_after - master_before`` within 5e-7 absolute, i.e. 0.2 % of lr
(measured at most 1.2e-7, one fp32 ulp of the master), and bf16 m, v and
params within one bf16 ulp (measured bit-equal).  This pins the algorithm:
clip, bias correction, decoupled decay, the bf16 round-trips.

One ``make_train_step`` on DeepSeek-v3 SMOKE, B=2, S=32, n_micro=2, bf16
weights with fp32 master, the reference at ``backend="pallas"``
(interpret mode) and the port at ``backend="cuda"`` (plain versions on CPU
tensors), from the same weights and batch.  Measured (softmax / sigmoid
router): loss 3.0e-4 / 2.2e-4 and grad_norm 2.2e-4 / 3.7e-4 relative apart
(limit 1e-2); m 1.5e-2 / 1.4e-2 and v 1.9e-2 / 2.0e-2 apart as a relative
norm over all leaves (limit 5e-2); the update ``master_after -
master_before`` differs by more than lr/20 in 0.60 % / 0.55 % of the
elements (limit 2 %).  Those elements differ by about 2·lr: a first Adam
step moves each weight by lr·sign(g), so a tiny gradient whose sign the
two packages' rounding flips steps the other way.  A skipped update, a
wrong lr or a missing bias correction moves every element.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_spec as jget_spec  # noqa: E402
from repro.data.synthetic import config_for, make_batch as jmake_batch  # noqa: E402,E501
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models.transformer import ModelOptions as JOptions  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.optim.adamw import init_train_state as jinit_state  # noqa: E402
from repro.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.configs import get_spec  # noqa: E402
from repro_torch.data import SyntheticConfig, make_batch  # noqa: E402
from repro_torch.models import ModelOptions, build_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.optim import init_train_state  # noqa: E402
from repro_torch.train import TrainConfig, make_train_step  # noqa: E402

SPEC = get_spec("deepseek-v3", smoke=True)
JSPEC = jget_spec("deepseek-v3", smoke=True)
BF16_ULP = 2.0 ** -8
LR = TA.AdamWConfig().lr


@pytest.mark.parametrize("step,grad_scale", [(0, 1.0), (2, 1.0), (2, 1e-3)])
def test_adamw_update_matches_reference(step, grad_scale):
    """grad_scale 1 gives a global norm of ~5.6 (clipped to 1), 1e-3 one of
    ~6e-3 (not clipped); step 2 starts from nonzero m and v."""
    rng = np.random.default_rng(step + int(grad_scale < 1))
    shapes = {"a": (64, 48), "b": (7,), "c": (3, 5, 9)}
    master = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    m = {k: (0.01 * rng.standard_normal(s) * (step > 0)).astype(np.float32)
         for k, s in shapes.items()}
    v = {k: (1e-4 * rng.random(s) * (step > 0)).astype(np.float32)
         for k, s in shapes.items()}
    g = {k: (0.1 * grad_scale * rng.standard_normal(s)).astype(np.float32)
         for k, s in shapes.items()}

    jstate, jmet = JA.adamw_update(JA.TrainState(
        step=jnp.int32(step),
        params={k: jnp.asarray(x, jnp.bfloat16) for k, x in master.items()},
        master={k: jnp.asarray(x) for k, x in master.items()},
        m={k: jnp.asarray(x, jnp.bfloat16) for k, x in m.items()},
        v={k: jnp.asarray(x, jnp.bfloat16) for k, x in v.items()}),
        {k: jnp.asarray(x) for k, x in g.items()}, JA.AdamWConfig())
    bf16 = {k: torch.tensor(x).bfloat16() for k, x in master.items()}
    state, met = TA.adamw_update(TA.TrainState(
        step=step, params=bf16,
        master={k: torch.tensor(x) for k, x in master.items()},
        m={k: torch.tensor(x).bfloat16() for k, x in m.items()},
        v={k: torch.tensor(x).bfloat16() for k, x in v.items()}),
        {k: torch.tensor(x) for k, x in g.items()}, TA.AdamWConfig())

    assert state.step == int(jstate.step) == step + 1
    assert state.params is bf16          # updated in place
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-6)
    for k in shapes:
        np.testing.assert_allclose(
            state.master[k].numpy() - master[k],
            np.asarray(jstate.master[k]) - master[k], rtol=0, atol=5e-7,
            err_msg=f"{k} update")
        for name, got, want in (("m", state.m, jstate.m),
                                ("v", state.v, jstate.v),
                                ("params", state.params, jstate.params)):
            np.testing.assert_allclose(
                got[k].float().numpy(), np.asarray(want[k], np.float32),
                rtol=BF16_ULP, atol=0, err_msg=f"{k} {name}")


def _rel_norm(got, want):
    """||got - want|| / ||want|| over every leaf of two name -> tensor maps."""
    num = sum(float(torch.linalg.vector_norm(got[k].float() - want[k].float()))
              ** 2 for k in want)
    den = sum(float(torch.linalg.vector_norm(want[k].float())) ** 2
              for k in want)
    return (num / den) ** 0.5


@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
def test_train_step_matches_reference(router):
    jm = jbuild_model(JSPEC, JOptions(backend="pallas", router_impl=router))
    params = jm.init(jax.random.PRNGKey(0))
    jbatch = jmake_batch(config_for(JSPEC, 2, 32), 0)
    jstate, jmetrics = jax.jit(jmake_train_step(jm, JTrainConfig(n_micro=2)))(
        jinit_state(params), jbatch)

    tm = build_model(SPEC, ModelOptions(backend="cuda", router_impl=router),
                     device="cpu")
    tm.load_params(params_from_jax(jax.tree.map(np.asarray, params)))
    state = init_train_state(dict(tm.named_parameters()))
    tbatch = make_batch(SyntheticConfig(2, 32, SPEC.vocab), 0, "cpu")
    state, metrics = make_train_step(tm, TrainConfig(n_micro=2))(state,
                                                                 tbatch)

    assert state.step == int(jstate.step) == 1
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]),
                                   rtol=1e-2, err_msg=key)
    tree = lambda t: params_from_jax(jax.tree.map(np.asarray, t))  # noqa
    want = tree(jstate.master)
    assert set(want) == set(state.master)
    for key, ours, theirs in (("m", state.m, jstate.m),
                              ("v", state.v, jstate.v)):
        gap = _rel_norm(ours, tree(theirs))
        assert gap < 5e-2, f"{key}: relative norm gap {gap}"
    n_off = n_all = 0
    for name, w in want.items():
        got = state.master[name]
        assert got.dtype == torch.float32, name
        # both start from the same master: this is the gap in the update
        off = (got - w).abs() > LR / 20
        n_off, n_all = n_off + int(off.sum()), n_all + off.numel()
        # the live bf16 weights are the master rounded
        assert torch.equal(state.params[name].detach(),
                           got.to(state.params[name].dtype)), name
    assert n_off < 0.02 * n_all, f"update differs in {n_off} of {n_all}"
