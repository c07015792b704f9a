"""The port's training step (percepnet_tpu_torch.train: loss, remat,
optimizer) against the JAX package's on the CPU, from the same params
(JAX's init carried across through the flat-npz format) and the same
numpy batches.

Bounds, with what a CPU run measured in brackets:
  - loss vs JAX's percepnet_loss: 1e-6 relative [< 1e-7];
  - gradients, remat on, vs jax.value_and_grad of JAX's loss_fn (remat
    on) at 2 x 12 and 2 x 100: 1e-5 of each leaf's max |g| [7.9e-7];
    remat on vs off in the port: the same bound [bit-equal in practice];
  - 8 Adam steps at 2 x 50 vs JAX's make_jitted_steps, with and without
    a global-norm clip: losses 1e-5 relative, params 1e-5 absolute
    [2.6e-7, 1.0e-7]; the counters equal;
  - the non-finite skip: counters equal to optax's apply_if_finite state
    after every step, params and moments unchanged by a skipped step;
  - on the golden records (saturated input stack) the bounds of
    tests/test_train_recipe_parity.py, see that test;
  - train.numerics.ExactProducts: values bit-equal to the f64 product
    rounded once, gradients bit-equal to the plain matmul's.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from percepnet_tpu.io.flat_npz import params_to_flat as j_params_to_flat
from percepnet_tpu.models import percepnet as j_model
from percepnet_tpu.train import datasets as j_datasets
from percepnet_tpu.train import state as j_ts
from percepnet_tpu.train.loss import percepnet_loss as j_loss
from percepnet_tpu_torch.io.flat_npz import params_from_flat, params_to_flat
from percepnet_tpu_torch.train import state as ts
from percepnet_tpu_torch.train.loss import percepnet_loss
from percepnet_tpu_torch.train.numerics import ExactProducts

torch.set_num_threads(2)

LOSS_REL = 1e-6
GRAD_REL = 1e-5          # of each leaf's max |g|
STEP_LOSS_REL = 1e-5
PARAM_ABS = 1e-5


def _port_model(j_params):
    """A port PercepNet holding JAX's params (copies: the flat arrays
    come back from JAX read-only)."""
    return params_from_flat({k: np.array(v) for k, v in
                             j_params_to_flat(jax.device_get(j_params))
                             .items()})


def _batch(bsz, t, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (bsz, t, 70)).astype(np.float32)
    y = rng.uniform(0.05, 0.95, (bsz, t, 68)).astype(np.float32)
    return x, y


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _assert_params_close(j_params, model, atol=PARAM_ABS):
    want = j_params_to_flat(jax.device_get(j_params))
    got = params_to_flat(model)
    worst = max(float(np.abs(want[k] - got[k]).max()) for k in want)
    assert worst <= atol, worst


@pytest.mark.parametrize("gain_mse_weight", [0.0, 0.5])
def test_loss_matches_jax(gain_mse_weight):
    """Value parity with JAX's percepnet_loss, and with the reference
    formula (rnn_train.py:153-176) at grad_eps=0."""
    rng = np.random.default_rng(0)
    out = rng.uniform(0.01, 0.99, (4, 7, 68)).astype(np.float32)
    tgt = rng.uniform(0.01, 0.99, (4, 7, 68)).astype(np.float32)
    for eps in (0.0, 1e-10):
        want = float(j_loss(jnp.asarray(out), jnp.asarray(tgt), eps,
                            gain_mse_weight))
        got = float(percepnet_loss(_t(out), _t(tgt), eps, gain_mse_weight))
        assert abs(got - want) <= LOSS_REL * want
    g_hat, r_hat, g, r = out[..., :34], out[..., 34:], tgt[..., :34], \
        tgt[..., 34:]
    dg = np.sqrt(g) - np.sqrt(g_hat)
    dr = np.sqrt(1 - r) - np.sqrt(1 - r_hat)
    ref = ((dg ** 2).mean() + 10.0 * (dg ** 4).mean() + (dr ** 2).mean()
           + gain_mse_weight * ((g - g_hat) ** 2).mean())
    assert abs(float(percepnet_loss(_t(out), _t(tgt), 0.0,
                                    gain_mse_weight)) - ref) < 1e-6


def _grads(model, x, y, remat):
    loss = ts.loss_fn(model, _t(x), _t(y), remat=remat)
    grads = torch.autograd.grad(loss, ts.parameters(model))
    return loss.item(), [g.numpy() for g in grads]


def test_remat_gradients_match_no_remat():
    """torch.utils.checkpoint per frame changes what backward stores, not
    the loss or the gradients."""
    model = _port_model(j_model.init_params(jax.random.PRNGKey(5)))
    x, y = _batch(2, 12, seed=6)
    l0, g0 = _grads(model, x, y, remat=False)
    l1, g1 = _grads(model, x, y, remat=True)
    assert abs(l0 - l1) <= LOSS_REL * l0
    for a, b in zip(g0, g1):
        assert np.abs(a - b).max() <= GRAD_REL * np.abs(a).max()


def _assert_grads_match_jax(t, seed, exact=False):
    params = j_model.init_params(jax.random.PRNGKey(5))
    x, y = _batch(2, t, seed=seed)
    want_loss, want = jax.jit(jax.value_and_grad(j_ts.loss_fn))(
        params, jnp.asarray(x), jnp.asarray(y))
    with ExactProducts() if exact else contextlib.nullcontext():
        got_loss, got = _grads(_port_model(params), x, y, remat=True)
    assert abs(got_loss - float(want_loss)) <= LOSS_REL * float(want_loss)
    want = j_params_to_flat(want)
    for (layer, leaf), g in zip(ts.LEAVES, got):
        w = want[f"params/{layer}/{leaf}"]
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= GRAD_REL, (layer, leaf, err)


@pytest.mark.parametrize("t", [12, 100])
def test_gradients_match_jax(t):
    _assert_grads_match_jax(t, seed=t)


def test_exact_products_round_once_and_keep_the_gradient():
    """Under train.numerics.ExactProducts an f32 matmul's value is its
    f64 product rounded once, also where ~1e7 terms cancel, and its
    gradient is the plain f32 matmul's, bit for bit; f64 products are
    left alone."""
    rng = np.random.default_rng(11)
    a = _t((rng.uniform(-1, 1, (3, 5, 64)) * 1e7).astype(np.float32))
    b = _t(rng.uniform(-1, 1, (64, 16)).astype(np.float32))
    up = _t(rng.standard_normal((3, 5, 16)).astype(np.float32))
    a.requires_grad_()
    b.requires_grad_()
    plain = torch.matmul(a, b)
    want_grads = torch.autograd.grad(plain, (a, b), up)
    with ExactProducts():
        out = torch.matmul(a, b)
        grads = torch.autograd.grad(out, (a, b), up)
        wide = torch.matmul(a.detach().double(), b.detach().double())
    assert torch.equal(out, torch.matmul(a.double(), b.double()).float())
    assert not torch.equal(out, plain)      # f32 sums round elsewhere
    for g, w in zip(grads, want_grads):
        assert torch.equal(g, w)
    assert torch.equal(wide, torch.matmul(a.double(), b.double()))


def test_exact_products_step_matches_jax():
    """The training step under ExactProducts (remat recomputing inside
    the block) is the same function: its gradients match
    jax.value_and_grad at 2 x 12 within the gradient bound."""
    _assert_grads_match_jax(12, seed=12, exact=True)


def _counters(opt_state, prefix):
    """(notfinite_count, last_finite, total_notfinite, count) as ints."""
    return tuple(int(np.asarray(opt_state[k])) for k in (
        "notfinite_count", "last_finite", "total_notfinite",
        prefix + "count"))


def _j_counters(state):
    s = state.opt_state
    inner = s.inner_state[0]
    if not isinstance(inner, optax.ScaleByAdamState):   # after the clip
        inner = s.inner_state[1][0]
    return tuple(int(v) for v in (s.notfinite_count, s.last_finite,
                                  s.total_notfinite, inner.count))


def _setup(clip_norm=None):
    """JAX's train state, jitted step and the port's optimizer and state
    from the same params."""
    tx = j_ts.make_optimizer(1e-4, clip_norm)
    jstate = j_ts.init_train_state(jax.random.PRNGKey(0), tx)
    jstep, _ = j_ts.make_jitted_steps(tx)
    opt = ts.make_optimizer(1e-4, clip_norm)
    return jstate, jstep, opt, ts.init_train_state(
        _port_model(jstate.params), opt)


def _run_both(batches, clip_norm=None):
    """Both packages through the same batches; the last states and both
    loss curves."""
    jstate, jstep, opt, state = _setup(clip_norm)
    curve = []
    for x, y in batches:
        jstate, jloss = jstep(jstate, x, y)
        loss = ts.train_step(state, _t(x), _t(y), opt)
        curve.append((float(jloss), float(loss)))
    return jstate, state, opt, curve


@pytest.mark.parametrize("clip_norm", [None, 1.0, 0.01])
def test_adam_steps_match_optax(clip_norm):
    """8 steps at 2 x 50.  The gradient's norm here is ~0.03: clip 1.0
    keeps it (the layout with the clip), 0.01 scales it."""
    batches = [_batch(2, 50, seed=100 + i) for i in range(8)]
    jstate, state, opt, curve = _run_both(batches, clip_norm)
    for jl, pl in curve:
        assert abs(jl - pl) <= STEP_LOSS_REL * jl
    _assert_params_close(jstate.params, state.model)
    assert _counters(state.opt_state, opt.adam_prefix) == \
        _j_counters(jstate) == (0, 1, 0, 8)
    assert int(state.step) == 8


def test_nonfinite_skip_matches_apply_if_finite():
    """NaN, finite, NaN batches: a skipped step leaves params, the Adam
    moments and their count untouched and advances `step`; the counters
    follow optax's after each step."""
    x, y = _batch(2, 50, seed=3)
    nan_x = x.copy()
    nan_x[0, 7, 3] = np.nan
    jstate, jstep, opt, state = _setup()
    expect = [(1, 0, 1, 0), (0, 1, 1, 1), (1, 0, 2, 1)]
    for i, bx in enumerate((nan_x, x, nan_x)):
        params = [p.detach().clone() for p in ts.parameters(state.model)]
        moments = {k: v.clone() for k, v in state.opt_state.items()
                   if k.startswith("inner_state/")}
        jstate, _ = jstep(jstate, bx, y)
        loss = ts.train_step(state, _t(bx), _t(y), opt)
        assert _counters(state.opt_state, opt.adam_prefix) == \
            _j_counters(jstate) == expect[i]
        assert int(state.step) == int(jstate.step) == i + 1
        _assert_params_close(jstate.params, state.model)
        if bx is nan_x:
            assert np.isnan(float(loss))
            for p, q in zip(ts.parameters(state.model), params):
                assert torch.equal(p, q)
            for k, v in moments.items():
                assert torch.equal(state.opt_state[k], v), k


def test_nonfinite_escape_after_max_consecutive_errors():
    """After more than 100 consecutive non-finite gradients the update is
    applied anyway (optax's escape), and a finite one resets the count;
    the state equals optax's at every step.  Both start at 99 non-finite
    steps in a row."""
    params = j_model.init_params(jax.random.PRNGKey(1))
    tx = optax.apply_if_finite(optax.adam(1e-4), max_consecutive_errors=100)
    jstate = tx.init(params)._replace(
        notfinite_count=jnp.asarray(99, jnp.int32),
        total_notfinite=jnp.asarray(99, jnp.int32))
    model = _port_model(params)
    opt = ts.make_optimizer(1e-4)
    state = opt.init(model)
    state["notfinite_count"].fill_(99)
    state["total_notfinite"].fill_(99)
    rng = np.random.default_rng(4)
    flat = j_params_to_flat(params)
    finite = {k: rng.standard_normal(v.shape).astype(np.float32) * 1e-2
              for k, v in flat.items()}
    bad = dict(finite)
    bad["params/gru2/wh"] = np.full(flat["params/gru2/wh"].shape, np.inf,
                                    np.float32)
    treedef = jax.tree.structure(params)
    expect = [(100, False, 100, 0), (101, False, 101, 1), (0, True, 101, 2)]
    jp = params
    for i, g in enumerate((bad, bad, finite)):
        leaves = [g[f"params/{layer}/{leaf}"] for layer, leaf in ts.LEAVES]
        upd, jstate = tx.update(
            jax.tree.unflatten(treedef, [jnp.asarray(v) for v in leaves]),
            jstate, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update(ts.parameters(model), [_t(v) for v in leaves], state)
        got = (int(state["notfinite_count"]), bool(state["last_finite"]),
               int(state["total_notfinite"]),
               int(state["inner_state/0/count"]))
        want = (int(jstate.notfinite_count), bool(jstate.last_finite),
                int(jstate.total_notfinite),
                int(jstate.inner_state[0].count))
        assert got == want == expect[i], (i, got, want)
        pf, jf = params_to_flat(model), j_params_to_flat(jp)
        for k in jf:
            np.testing.assert_allclose(pf[k], jf[k], atol=PARAM_ABS)
        if i == 0:
            for k in jf:
                np.testing.assert_array_equal(pf[k], flat[k])
    # the escape applied an infinite gradient: gru2's weights are gone
    assert not np.isfinite(params_to_flat(model)["params/gru2/wh"]).any()


def test_log1p_unsaturates_input_stack():
    """Raw-scale features (~1e8) saturate conv2's tanh: fc/conv1/conv2 get
    exactly zero gradient, in the port as in JAX; log1p_features restores
    the flow."""
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 3e8, (2, 8, 70)).astype(np.float32)
    x[..., 68:] = rng.uniform(0, 1, (2, 8, 2))
    y = rng.uniform(0.05, 0.95, (2, 8, 68)).astype(np.float32)
    model = _port_model(j_model.init_params(jax.random.PRNGKey(0)))
    stack = [i for i, (layer, _) in enumerate(ts.LEAVES)
             if layer in ("fc", "conv1", "conv2")]
    for log1p in (False, True):
        loss = ts.loss_fn(model, _t(x), _t(y), log1p_features=log1p)
        grads = torch.autograd.grad(loss, ts.parameters(model))
        top = max(float(grads[i].abs().max()) for i in stack)
        assert (top > 0.0) == log1p


def test_index_step_gathers_like_loader_step():
    """The card-resident corpus steps (gather on the device) equal the
    host-batch steps, bit for bit on one device."""
    rng = np.random.default_rng(9)
    recs = rng.uniform(0.05, 0.95, (5, 6, 138)).astype(np.float32)
    xa, ya = (_t(a.copy()) for a in j_datasets.split_xy(recs))
    idx = np.array([3, 1], np.int32)
    params = j_model.init_params(jax.random.PRNGKey(2))
    results = []
    for make in (ts.make_steps, ts.make_index_steps):
        opt = ts.make_optimizer(1e-4)
        state = ts.init_train_state(_port_model(params), opt)
        step, ev = make(opt)
        args = ((xa, ya, torch.from_numpy(idx.astype(np.int64)))
                if make is ts.make_index_steps else (xa[idx], ya[idx]))
        loss = step(state, *args)
        results.append((float(loss), float(ev(state, *args)),
                        params_to_flat(state.model)))
    assert results[0][:2] == results[1][:2]
    for k, v in results[0][2].items():
        np.testing.assert_array_equal(v, results[1][2][k])


SEQ, STEPS = 100, 8


def test_loss_curve_matches_jax_on_golden_records(featgen_goldens):
    """tests/test_train_recipe_parity.py's setup (golden records, x30,
    clipped targets, two chunks of 100 frames, 8 steps) through JAX and
    the port from the same params, with that test's curve bound.

    Raw-scale energies (~1e8) saturate the input stack, so many gradients
    are rounding noise, and Adam turns noise of either sign into a step
    of about the learning rate: the first losses agree to 1e-6 [2.2e-7],
    later ones part [2.5e-3 at step 7], and a weight can part by at most
    about 2 x lr per step [6.8e-4 after 8 steps, bound 1.6e-3]."""
    rec = featgen_goldens["records"].astype(np.float32).copy()
    rec[:, :68] *= 30.0
    rec[:, 70:] = np.clip(rec[:, 70:], 0.0, 1.0)
    x, y = j_datasets.split_xy(rec[None])
    batches = [(np.ascontiguousarray(x[:, i * SEQ : (i + 1) * SEQ]),
                np.ascontiguousarray(y[:, i * SEQ : (i + 1) * SEQ]))
               for i in [0, 1]] * (STEPS // 2)
    jstate, state, _, curve = _run_both(batches)
    rel = [abs(jl - pl) / jl for jl, pl in curve]
    assert max(rel[:2]) <= LOSS_REL
    assert max(rel) < 2e-2          # test_train_recipe_parity's bound
    _assert_params_close(jstate.params, state.model, atol=2 * STEPS * 1e-4)
    assert curve[-1][1] < curve[0][1]
