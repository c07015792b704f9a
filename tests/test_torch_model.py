"""The port's PercepNet module against JAX models.percepnet.forward, with
the same weights loaded on both sides: g/r within 1e-5 on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percepnet_tpu.io.flat_npz import params_from_flat as j_params_from_flat
from percepnet_tpu.models import percepnet as j_model
from percepnet_tpu.ops import activations as j_act
from percepnet_tpu_torch import constants as C
from percepnet_tpu_torch.io.flat_npz import load_params, params_from_flat
from percepnet_tpu_torch.models.percepnet import (LAYERS, PercepNet,
                                                  init_model_state)
from percepnet_tpu_torch.ops import activations

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(__file__))
CHECKPOINT = os.path.join(ROOT, "artifacts", "exp_log1p_30000_params.npz")
NN_GOLDEN = os.path.join(ROOT, "tests", "goldens", "nn.npz")


@pytest.fixture(scope="module")
def checkpoint():
    with np.load(CHECKPOINT) as data:
        return dict(data)


def _features(bsz, t, seed):
    rng = np.random.default_rng(seed)
    f = rng.random((bsz, t, C.NB_FEATURES)).astype(np.float32)
    f[..., :68] *= 300.0                  # band energies / coherence x30
    f[..., 68] = rng.integers(60, 769, (bsz, t)) / C.PITCH_T_NORM
    return f


def test_params_from_flat_loads_every_leaf(checkpoint):
    model = params_from_flat(checkpoint)
    assert sum(p.numel() for p in model.parameters()) == 7_962_564
    for layer, leaves in LAYERS.items():
        for leaf in leaves:
            np.testing.assert_array_equal(
                getattr(model, layer)[leaf].detach().numpy(),
                checkpoint[f"params/{layer}/{leaf}"])
    assert load_params(CHECKPOINT).gru_rb["wi"].shape == (1024, 384)


@pytest.mark.parametrize("fault", ["missing", "shape"])
def test_params_from_flat_rejects_bad_mapping(checkpoint, fault):
    bad = dict(checkpoint)
    if fault == "missing":
        del bad["params/gru2/wh"]
        with pytest.raises(KeyError):
            params_from_flat(bad)
    else:
        bad["params/fc/b"] = np.zeros(127, np.float32)
        with pytest.raises(ValueError):
            params_from_flat(bad)


def test_init_is_seeded_by_generator():
    a = PercepNet(torch.Generator().manual_seed(3))
    b = PercepNet(torch.Generator().manual_seed(3))
    c = PercepNet(torch.Generator().manual_seed(4))
    np.testing.assert_array_equal(a.gru1["wh"].detach(), b.gru1["wh"].detach())
    assert not torch.equal(a.gru1["wh"], c.gru1["wh"])
    bound = 1.0 / np.sqrt(C.GRU_DIM)
    assert a.gru1["wh"].abs().max().item() <= bound


def test_forward_matches_jax_log1p(checkpoint):
    feats = _features(2, 30, seed=1)
    jp = j_params_from_flat(j_model.init_params(jax.random.PRNGKey(0)),
                            checkpoint)
    jg, jr, jst = j_model.forward(jp, jnp.asarray(feats), log1p_features=True)
    with torch.no_grad():
        g, r, st = params_from_flat(checkpoint)(torch.from_numpy(feats),
                                                log1p_features=True)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-5)
    for name in ("h1", "h_rb", "conv2_mem"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(jst, name)), atol=1e-5)


def test_forward_compat_matches_jax():
    with np.load(NN_GOLDEN) as data:
        flat = {k: data[k] for k in data.files if k.startswith("params/")}
    feats = _features(1, 25, seed=2)
    jp = j_params_from_flat(j_model.init_params(jax.random.PRNGKey(0)), flat)
    jg, jr, _ = j_model.forward(jp, jnp.asarray(feats),
                                act_tanh=j_act.tansig_approx,
                                act_sigmoid=j_act.sigmoid_approx)
    with torch.no_grad():
        g, r, _ = params_from_flat(flat)(
            torch.from_numpy(feats), act_tanh=activations.tansig_approx,
            act_sigmoid=activations.sigmoid_approx)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-5)


def test_forward_state_carry_chunked_equals_oneshot():
    model = PercepNet(torch.Generator().manual_seed(0))
    feats = torch.from_numpy(_features(2, 12, seed=3)) / 30.0
    with torch.no_grad():
        g, r, st = model(feats)
        state = init_model_state(2, torch.device("cpu"))
        gs, rs = [], []
        for i in range(0, 12, 4):
            gi, ri, state = model(feats[:, i:i + 4], state)
            gs.append(gi)
            rs.append(ri)
    np.testing.assert_allclose(torch.cat(gs, 1).numpy(), g.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(torch.cat(rs, 1).numpy(), r.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(state.h3.numpy(), st.h3.numpy(), atol=1e-5)
