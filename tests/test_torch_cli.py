"""The port's command surface (python -m percepnet_tpu_torch ...) on the
CPU: `enhance` in batch and streaming against the JAX package's CLI on the
same two files, `--compat` against the C binary's g/r, `export`, and the
dispatcher and `bench` refusing what they must refuse.

Bounds, in int16 LSB of the written files unless stated (measured on
these inputs, from a CPU run, in brackets):
  - f32 batch and streaming vs JAX's CLI: 1 LSB [0]; --dump-gr g/r:
    1e-5 [< 1e-6];
  - bf16: 3e-3 x 32768 + 32 LSB at raw scale, the repo's bf16
    streaming-vs-batch bound (tests/test_pipeline.py), against the port's
    own f32 CLI [55, 86] and against JAX's bf16 CLI at the clip's own
    level [42], and correlation >= 0.99 with JAX's bf16 output [0.997];
    at 3x the clip's level JAX's bf16 tier is 642 LSB from its own f32
    tier, so there the port's bf16 output is held to be no farther from
    JAX's f32 output than JAX's bf16 output is [55]; the port's bf16
    output differs from its f32 output (an ignored --bf16 fails);
  - why the two bf16 tiers part at 3x: JAX's bf16 sigmoid rounds three
    times, torch.sigmoid once.  Given a sigmoid that rounds once, JAX's
    bf16 model follows the port's on the same features within 0.03, the
    repo's bf16 g/r bound (tests/test_model.py), here as a max [g 3e-3,
    r 1.2e-2]; with its own it does not [r 0.12];
  - --compat --dump-gr vs the C binary's feature_test.raw
    (tests/goldens/nn.npz): 1e-5, as tests/test_cli.py holds JAX's.
"""

import os

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percepnet_tpu.cli import enhance as j_enhance
from percepnet_tpu.models import percepnet as j_model
from percepnet_tpu_torch import __main__ as dispatcher
from percepnet_tpu_torch.cli import enhance
from percepnet_tpu_torch.features import frontend
from percepnet_tpu_torch.io.flat_npz import load_params

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(__file__))
CHECKPOINT = os.path.join(ROOT, "artifacts", "exp_log1p_30000_params.npz")
NN_GOLDEN = os.path.join(ROOT, "tests", "goldens", "nn.npz")
# the round-5 checkpoint needs both (cli/enhance.py's scale note)
CKPT_FLAGS = ["--weights", CHECKPOINT, "--log1p", "--raw-scale"]
BF16_LSB = 3e-3 * 32768 + 32
BF16_MIN_CORR = 0.99
BF16_GR_TOL = 0.03
F32_LSB = 1
GR_TOL = 1e-5
BATCH_FRAMES = "16"          # chunks end inside both files


def _read(path):
    return np.fromfile(path, "<i2").astype(np.int32)


def _max_lsb(a, b):
    a, b = _read(a), _read(b)
    assert a.shape == b.shape
    return int(np.abs(a - b).max())


@pytest.fixture(scope="module")
def files(tmp_path_factory, featgen_goldens):
    """Two inputs from the golden clip: all 200 frames at 3x its level
    (a), and 100 frames plus a ragged tail from frame 37 at its own level
    (b).  The checkpoint leaves ~1% of full scale of the clip at its own
    level (peak ~370 LSB) and ~9% at 3x (peak ~2,900)."""
    d = tmp_path_factory.mktemp("pcm")
    noisy = featgen_goldens["noisy16"].astype(np.float64)
    paths = [str(d / "a.pcm"), str(d / "b.pcm")]
    np.clip(noisy * 3.0, -32768, 32767).astype("<i2").tofile(paths[0])
    noisy[37 * 480 : 137 * 480 + 123].astype("<i2").tofile(paths[1])
    return paths


@pytest.fixture(scope="module")
def jax_outputs(files, tmp_path_factory):
    """JAX's CLI on the files: f32 batch with --dump-gr, bf16 batch and
    streaming (one compile each)."""
    d = tmp_path_factory.mktemp("jax")
    out = {}
    for tag, extra in (("f32", ["--dump-gr"]), ("bf16", ["--bf16"])):
        out[tag] = str(d / tag)
        j_enhance.main(files + ["--out-dir", out[tag], "--batch-frames",
                                BATCH_FRAMES] + CKPT_FLAGS + extra)
    out["stream"] = str(d / "stream.pcm")
    j_enhance.main([files[0], out["stream"], "--streaming"] + CKPT_FLAGS)
    return out


def _port(*args):
    dispatcher.main(["enhance", *args, "--device", "cpu"])


@pytest.fixture(scope="module")
def port_f32(files, tmp_path_factory):
    """The port's f32 batch CLI on the files, with --dump-gr."""
    d = str(tmp_path_factory.mktemp("port"))
    _port(*files, "--out-dir", d, "--batch-frames", BATCH_FRAMES,
          "--dump-gr", *CKPT_FLAGS)
    return d


def test_enhance_batch_matches_jax_cli(files, jax_outputs, port_f32):
    for p in files:
        name = os.path.basename(p)
        assert _max_lsb(os.path.join(port_f32, name),
                        os.path.join(jax_outputs["f32"], name)) <= F32_LSB
        gr = np.fromfile(os.path.join(port_f32, name + ".gr.raw"), "<f4")
        j_gr = np.fromfile(os.path.join(jax_outputs["f32"],
                                        name + ".gr.raw"), "<f4")
        # 68 floats per input frame, none dropped
        assert gr.shape == j_gr.shape == (
            (os.path.getsize(p) // 2 // 480) * 68,)
        np.testing.assert_allclose(gr, j_gr, atol=GR_TOL)


def test_enhance_streaming_matches_jax_cli(files, jax_outputs, tmp_path,
                                           capsys):
    out = str(tmp_path / "s.pcm")
    _port(files[0], out, "--streaming", "--report-latency", *CKPT_FLAGS)
    assert _max_lsb(out, jax_outputs["stream"]) <= F32_LSB
    assert "per-frame step time" in capsys.readouterr().out


def test_enhance_bf16_matches_jax_cli(files, jax_outputs, port_f32,
                                     tmp_path):
    _port(*files, "--out-dir", str(tmp_path), "--batch-frames",
          BATCH_FRAMES, "--bf16", *CKPT_FLAGS)
    out = {}
    for tag, d in (("bf16", str(tmp_path)), ("f32", port_f32),
                   ("jax_bf16", jax_outputs["bf16"]),
                   ("jax_f32", jax_outputs["f32"])):
        out[tag] = {n: _read(os.path.join(d, n)) for n in ("a.pcm", "b.pcm")}

    def lsb(x, y, name):
        return int(np.abs(out[x][name] - out[y][name]).max())

    for name in ("a.pcm", "b.pcm"):
        # the bf16 tier against its own f32 tier [55, 86 LSB], and not
        # equal to it: --bf16 took effect
        assert 0 < lsb("bf16", "f32", name) <= BF16_LSB
        assert np.corrcoef(out["bf16"][name],
                           out["jax_bf16"][name])[0, 1] >= BF16_MIN_CORR
    # b, at the clip's own level: against JAX's bf16 CLI [42 LSB]
    assert lsb("bf16", "jax_bf16", "b.pcm") <= BF16_LSB
    # a, at 3x: JAX's bf16 tier is itself 642 LSB from its f32 tier
    # there, and the two bf16 tiers sit 613 apart (correlation 0.997);
    # the port's bf16 tier must be no farther from the f32 reference than
    # JAX's is [55 vs 642 LSB]
    assert lsb("bf16", "jax_f32", "a.pcm") <= lsb("jax_bf16", "jax_f32",
                                                  "a.pcm")


def test_bf16_gap_to_jax_is_its_sigmoid_rounding(files):
    """At 3x the clip's level the two packages' bf16 tiers part (the
    test above).  The cause: JAX's bf16 jax.nn.sigmoid is 1/(1+exp(-x))
    rounded to bf16 after the exp, the add and the divide (one ulp off
    on ~3% of bf16 inputs, biased), where torch.sigmoid rounds the exact
    value once; the GRU gates carry the difference through the frames.
    On the same features, JAX's bf16 model with a sigmoid that rounds
    once follows the port's bf16 model; with its own it does not."""
    x = np.fromfile(files[0], "<i2").astype(np.float32)
    with torch.no_grad():
        front, _ = frontend.analyze_batch(
            torch.from_numpy(x[None, : x.size // 480 * 480]), serving=True)
        feats = front["features"]
        model16 = copy.deepcopy(load_params(CHECKPOINT)).to(torch.bfloat16)
        g, r, _ = model16(feats, log1p_features=True,
                          compute_dtype=torch.bfloat16)
    ours = np.concatenate([g[0].float().numpy(), r[0].float().numpy()], -1)

    def sigmoid_rounded_once(v):
        return jax.nn.sigmoid(v.astype(jnp.float32)).astype(v.dtype)

    params = j_enhance.load_params(CHECKPOINT)
    gap = {}
    for tag, sig in (("once", sigmoid_rounded_once),
                     ("jax", jax.nn.sigmoid)):
        jg, jr, _ = j_model.forward(params, jnp.asarray(feats.numpy()),
                                    log1p_features=True,
                                    compute_dtype=jnp.bfloat16,
                                    act_sigmoid=sig)
        theirs = np.concatenate([np.asarray(jg)[0], np.asarray(jr)[0]], -1)
        gap[tag] = float(np.abs(ours - theirs).max())
    assert gap["once"] <= BF16_GR_TOL < gap["jax"], gap


def test_keep_first_frame_keeps_the_reference_frame(files, tmp_path):
    """Without --keep-first-frame the output is one frame shorter than the
    whole input frames, and equals the kept output from its frame 1."""
    kept, dropped = str(tmp_path / "k.pcm"), str(tmp_path / "d.pcm")
    for out, extra in ((kept, ["--keep-first-frame"]), (dropped, [])):
        _port(files[1], out, "--batch-frames", BATCH_FRAMES, *extra,
              *CKPT_FLAGS)
    n_frames = os.path.getsize(files[1]) // 2 // 480
    k, d = _read(kept), _read(dropped)
    assert k.size == n_frames * 480 and d.size == (n_frames - 1) * 480
    np.testing.assert_array_equal(d, k[480:])


def test_compat_dump_gr_matches_c_binary(tmp_path, featgen_goldens):
    """--compat (the C tansig/sigmoid tables) with the C binary's weights
    reproduces its feature_test.raw side channel (denoise.cpp:533-534)."""
    noisy = str(tmp_path / "noisy.pcm")
    featgen_goldens["noisy16"].astype("<i2").tofile(noisy)
    gr_path = str(tmp_path / "feature_test.raw")
    _port(noisy, str(tmp_path / "out.pcm"), "--weights", NN_GOLDEN,
          "--compat", "--batch-frames", "200", "--dump-gr", gr_path)
    gr = np.fromfile(gr_path, "<f4").reshape(-1, 68)
    with np.load(NN_GOLDEN) as nn:
        ref = nn["gr"]
    assert gr.shape == ref.shape
    np.testing.assert_allclose(gr, ref, atol=GR_TOL)


def test_export_cpp_then_enhance_gives_the_npz_output(files, tmp_path):
    """export .npz -> .cpp -> .npz keeps every weight, so enhance with the
    exported .cpp writes the .npz's bytes."""
    cpp, npz = str(tmp_path / "w.cpp"), str(tmp_path / "w.npz")
    dispatcher.main(["export", CHECKPOINT, cpp, "--device", "cpu"])
    dispatcher.main(["export", cpp, npz, "--device", "cpu"])
    with np.load(CHECKPOINT) as a, np.load(npz) as b:
        assert sorted(b.files) == sorted(a.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    outs = {}
    for tag, w in (("npz", CHECKPOINT), ("cpp", cpp)):
        outs[tag] = str(tmp_path / f"{tag}.pcm")
        _port(files[1], outs[tag], "--weights", w, "--log1p", "--raw-scale")
    with open(outs["npz"], "rb") as a, open(outs["cpp"], "rb") as b:
        assert a.read() == b.read()


def test_export_refuses_other_destinations(tmp_path):
    with pytest.raises(SystemExit) as e:
        dispatcher.main(["export", CHECKPOINT, str(tmp_path / "w.h5"),
                         "--device", "cpu"])
    assert e.value.code == 2


def test_dump_gr_refused_with_streaming(files, tmp_path):
    with pytest.raises(SystemExit) as e:
        _port(files[0], str(tmp_path / "o.pcm"), "--streaming",
              "--dump-gr", *CKPT_FLAGS)
    assert e.value.code == 2


@pytest.mark.parametrize("argv,code", [(["--help"], 0), ([], 2),
                                       (["frobnicate"], 2), (["train"], 2),
                                       (["split-dataset"], 2),
                                       (["bin2h5"], 2)])
def test_dispatcher_exit_codes(argv, code, capsys):
    with pytest.raises(SystemExit) as e:
        dispatcher.main(argv)
    assert e.value.code == code
    out = capsys.readouterr()
    if argv == ["--help"]:
        listed = out.out.split("commands:")[1].split()
        assert listed == ["bench", "enhance", "evaluate", "export",
                          "featgen"]
    if argv and argv[0] in dispatcher.NOT_PORTED:
        assert "not ported" in out.err


def test_bench_refuses_without_a_card(capsys):
    """Without a card the bench exits 3 and prints no JSON line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit) as e:
        dispatcher.main(["bench", "--batch=4", "--frames=2"])
    assert e.value.code == 3
    out = capsys.readouterr()
    assert "{" not in out.out and "no CUDA card" in out.err


@pytest.mark.parametrize("cmd", ["enhance", "featgen", "export",
                                 "evaluate"])
def test_commands_raise_without_a_card(cmd, files, tmp_path):
    """Without --device cpu every command asks for the card and raises
    when there is none; nothing falls back to the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    argv = {"enhance": [files[0], str(tmp_path / "o.pcm"), *CKPT_FLAGS],
            "featgen": [files[0], files[0], "4", str(tmp_path / "o.f32")],
            "export": [CHECKPOINT, str(tmp_path / "w.npz")],
            "evaluate": [files[0], files[0]]}[cmd]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dispatcher.main([cmd, *argv])
    assert not any(tmp_path.iterdir())
