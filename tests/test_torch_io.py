"""The port's weight and PCM I/O against the JAX package's, on the CPU:
s16le files byte for byte, flat and TrainState .npz files, rnn_train.py
state_dicts and nnet_data.cpp, each with the same inputs through both
packages.  Tolerance: none; every array and file compared here is equal
exactly."""

import jax
import numpy as np
import pytest
import torch

from percepnet_tpu.io import nnet_data as j_nnet_data
from percepnet_tpu.io import pcm as j_pcm
from percepnet_tpu.io.flat_npz import params_from_flat as j_params_from_flat
from percepnet_tpu.io.flat_npz import params_to_flat as j_params_to_flat
from percepnet_tpu.io.torch_import import params_from_state_dict
from percepnet_tpu.models import percepnet as j_model
from percepnet_tpu.train import checkpoint as j_ckpt
from percepnet_tpu.train.state import init_train_state, make_optimizer
from percepnet_tpu_torch.cli.enhance import load_params
from percepnet_tpu_torch.io import flat_npz, nnet_data, pcm
from percepnet_tpu_torch.io.torch_import import model_from_state_dict
from percepnet_tpu_torch.models.percepnet import PercepNet

torch.set_num_threads(2)


def _assert_same_params(model, jax_params):
    """Every parameter of the port's model equals the JAX pytree's."""
    ours = flat_npz.params_to_flat(model)
    theirs = j_params_to_flat(jax_params)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k], np.asarray(v), err_msg=k)


@pytest.fixture(scope="module")
def model():
    return PercepNet(torch.Generator().manual_seed(7))


def test_pcm_files_equal_jax_byte_for_byte(tmp_path):
    rng = np.random.default_rng(0)
    # fractions of both signs (truncation toward zero) and values past
    # both int16 limits (clipping)
    x = np.concatenate([rng.normal(0.0, 0.3, 4000),
                        [1.5, -1.5, 0.99999, -0.99999, -3e-5, 3e-5]])
    x = x.astype(np.float32)
    # raw amplitudes and the /32768 scale
    for data, scale in ((x * 1000.0, 1.0), (x, 32768.0)):
        ours, theirs = tmp_path / "ours.pcm", tmp_path / "theirs.pcm"
        pcm.write_pcm16(str(ours), data, scale=scale)
        j_pcm.write_pcm16(str(theirs), data, scale=scale)
        assert ours.read_bytes() == theirs.read_bytes()
        for normalize in (False, True):
            np.testing.assert_array_equal(
                pcm.read_pcm16(str(ours), normalize=normalize),
                j_pcm.read_pcm16(str(theirs), normalize=normalize))


def test_trainstate_checkpoint_with_clipping_loads_params(tmp_path):
    """A TrainState .npz whose optimizer clips (a non-default opt_state
    tree) loads its params/* subtree without the optimizer
    (tests/test_cli.py's JAX counterpart)."""
    st = init_train_state(jax.random.PRNGKey(1),
                          make_optimizer(1e-4, clip_norm=5.0))
    path = str(tmp_path / "checkpoint-0.npz")
    j_ckpt.save_checkpoint(path, jax.device_get(st))
    with np.load(path) as z:
        assert "step" in z.files
    _assert_same_params(load_params(path), st.params)


def test_params_npz_interchanges_with_jax(tmp_path, model):
    """The port's params-only .npz has JAX's keys and loads there exactly;
    JAX's loads in the port exactly."""
    ours = str(tmp_path / "ours.npz")
    flat_npz.save_params_npz(ours, model)
    template = j_model.init_params(jax.random.PRNGKey(0))
    loaded = j_ckpt.load_params_npz(ours, template)
    _assert_same_params(model, loaded)
    theirs = str(tmp_path / "theirs.npz")
    j_ckpt.save_params_npz(theirs, loaded)
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
    _assert_same_params(load_params(theirs), loaded)


def test_state_dict_import_equals_jax(tmp_path):
    """rnn_train.py's state_dict (tests/test_train_recipe_parity.py's
    TorchPercepNet) imports exactly as JAX's params_from_state_dict does,
    in memory and from a .pt file."""
    from test_train_recipe_parity import TorchPercepNet
    torch.manual_seed(3)
    sd = TorchPercepNet().state_dict()
    theirs = params_from_state_dict(sd)
    _assert_same_params(model_from_state_dict(sd), theirs)
    path = str(tmp_path / "model.pt")
    torch.save(sd, path)
    _assert_same_params(load_params(path), theirs)


@pytest.mark.parametrize("key", ["fc.0.weight", "conv1.0.weight",
                                 "gru1.weight_ih_l0", "gru_rb.bias_hh_l0"])
def test_state_dict_import_rejects_wrong_shapes(key):
    from test_train_recipe_parity import TorchPercepNet
    sd = TorchPercepNet().state_dict()
    sd[key] = sd[key][..., :-1]
    with pytest.raises(ValueError, match=key.split(".")[0]):
        model_from_state_dict(sd)


def test_nnet_data_emit_and_parse_equal_jax(tmp_path, model):
    """The port's nnet_data.cpp is JAX's text byte for byte, and the port
    parses JAX's file to exactly the weights it holds (one full-width
    emit in each package and one parse)."""
    theirs_params = j_params_from_flat(
        j_model.init_params(jax.random.PRNGKey(0)),
        flat_npz.params_to_flat(model))
    ours, theirs = tmp_path / "ours.cpp", tmp_path / "theirs.cpp"
    nnet_data.emit_nnet_data_cpp(model, str(ours))
    j_nnet_data.emit_nnet_data_cpp(theirs_params, str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    _assert_same_params(nnet_data.model_from_nnet_data_cpp(str(theirs)),
                        theirs_params)


def test_nnet_data_parse_reads_float_suffixes(tmp_path):
    """Literals with the C `f` suffix and a trailing comma parse through
    a double, as JAX's parser reads them."""
    text = ("static const float a_weights[4] = {\n   0.1f, -2.5e-3f,\n"
            "   1e-45f, 3.4028235e38f,\n};\n")
    got = nnet_data._parse_arrays(text)["a_weights"]
    want = j_nnet_data._parse_arrays(text)["a_weights"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_load_params_rejects_unknown_format(tmp_path):
    with pytest.raises(ValueError, match="unknown weight format"):
        load_params(str(tmp_path / "w.bin"))
