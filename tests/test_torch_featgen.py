"""The port's feature/label generation on the CPU: records and the oracle
enhancement of `featgen` against the C binary's goldens
(tests/goldens/featgen.npz) with the bounds of tests/test_featgen_parity.py,
the label math and post-filter against the JAX package's on the same
analyses, augmentation against JAX's draws, and the CLI's batching,
sharding and resume.

Bounds (measured on these inputs, from a CPU run, in brackets):
  - records vs the C binary: band energies 1e-4 relative (floor 1e-3)
    [7.5e-5]; coherence 1e-4 [1.8e-5]; periods exact; pitch correlation
    1e-3 relative [1.3e-4]; g 1e-4 [2.0e-5]; r: at most the one flip
    (|diff| > 0.02) the JAX package's gate allows, each at a borderline
    r = 0.99 override margin (|Ephatp - Exp| < 5e-4), median 1e-5 [0].
    At frame 123 band 22 (JAX's one flip) the port's margin is -4.4e-4 to
    -9.2e-4 (the clean clip's band-22 coherence there moves with the
    CPU's thread count): it takes the override as the C binary does, so
    it measures 0 flips;
  - oracle PCM vs the C binary: 1e-4 normalized [3.1e-5];
  - labels and post-filter vs JAX: 1e-5 [f32 rounding];
  - augmentation: equal to JAX's bit for bit;
  - batched vs single-pair records: 2e-5 (tests/test_cli.py's bound).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percepnet_tpu.features import augment as j_augment
from percepnet_tpu.features import labels as j_labels
from percepnet_tpu.ops.postfilter import post_filter as j_post_filter
from percepnet_tpu_torch import __main__ as dispatcher
from percepnet_tpu_torch.cli.featgen import generate_batch, generate_pair
from percepnet_tpu_torch.features import augment, labels
from percepnet_tpu_torch.features.frontend import analyze_utterance
from percepnet_tpu_torch.ops.postfilter import post_filter

torch.set_num_threads(2)

CPU = "cpu"
RECORD_DIM = 138


def relerr(a, b, floor=1e-3):
    return np.abs(a - b) / np.maximum(np.abs(b), floor)


@pytest.fixture(scope="module")
def analyses(featgen_goldens):
    """The port's analyses of the golden clean and noisy clips."""
    g = featgen_goldens
    with torch.no_grad():
        clean_out, _ = analyze_utterance(
            torch.from_numpy(g["clean16"].astype(np.float32)))
        noisy_out, _ = analyze_utterance(
            torch.from_numpy(g["noisy16"].astype(np.float32)))
    return clean_out, noisy_out


@pytest.fixture(scope="module")
def featgen_run(featgen_goldens, tmp_path_factory):
    """`featgen clean noisy 200 out.f32 --test` on the golden clips."""
    d = tmp_path_factory.mktemp("featgen")
    g = featgen_goldens
    clean, noisy = str(d / "clean.pcm"), str(d / "noisy.pcm")
    g["clean16"].astype("<i2").tofile(clean)
    g["noisy16"].astype("<i2").tofile(noisy)
    out = str(d / "out.f32")
    dispatcher.main(["featgen", clean, noisy, "200", out, "--test",
                     "--device", CPU])
    return d, np.fromfile(out, "<f4").reshape(-1, RECORD_DIM)


def test_records_match_c_binary(featgen_run, featgen_goldens, analyses):
    _, rec = featgen_run
    ref = featgen_goldens["records"]
    assert rec.shape == ref.shape
    assert relerr(rec[:, :34], ref[:, :34]).max() < 1e-4
    assert np.abs(rec[:, 34:68] - ref[:, 34:68]).max() < 1e-4
    np.testing.assert_array_equal(np.round(rec[:, 68] * 588),
                                  np.round(ref[:, 68] * 588))
    assert relerr(rec[:, 69], ref[:, 69]).max() < 1e-3
    assert np.abs(rec[:, 70:104] - ref[:, 70:104]).max() < 1e-4
    clean_out, noisy_out = analyses
    margin = (labels.estimate_phat_corr(noisy_out["exp"])
              - clean_out["exp"]).numpy()
    r_diff = np.abs(rec[:, 104:138] - ref[:, 104:138])
    flips = np.argwhere(r_diff > 0.02)
    assert len(flips) <= 1, flips
    for t, b in flips:
        assert abs(margin[t, b]) < 5e-4, (t, b, margin[t, b])
    assert np.median(r_diff) < 1e-5


def test_oracle_output_matches_c_binary(featgen_run, featgen_goldens):
    d, _ = featgen_run
    ours = np.fromfile(d / "test_output.pcm", "<i2").astype(np.float32)
    oracle = featgen_goldens["oracle_pcm"].astype(np.float32)
    n = min(len(ours), len(oracle))
    assert np.abs(ours[:n] - oracle[:n]).max() / 32768.0 < 1e-4
    np.testing.assert_array_equal(
        np.fromfile(d / "test_input.pcm", "<i2"), featgen_goldens["noisy16"])


@pytest.mark.parametrize("postfilter", [True, False])
def test_labels_match_jax(analyses, postfilter):
    """make_labels / make_records on the same analyses, single and
    batched, through both packages."""
    clean_out, noisy_out = analyses
    batched = [{k: torch.stack([v, v.flip(0)]) for k, v in out.items()}
               for out in analyses]
    for c, n in ((clean_out, noisy_out), tuple(batched)):
        ours = labels.make_labels(c, n, apply_postfilter=postfilter)
        theirs = j_labels.make_labels(
            {k: jnp.asarray(v.numpy()) for k, v in c.items()},
            {k: jnp.asarray(v.numpy()) for k, v in n.items()},
            apply_postfilter=postfilter)
        for k in ("g", "r", "eyp", "ephatp"):
            np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]),
                                       atol=1e-5, err_msg=k)
        rec = labels.make_records(c, n, apply_postfilter=postfilter)
        assert rec.shape == n["exp"].shape[:-1] + (RECORD_DIM,)


def test_post_filter_matches_jax():
    rng = np.random.default_rng(4)
    g = rng.uniform(0.0, 1.0, (3, 50, 34)).astype(np.float32)
    ey = rng.uniform(0.0, 1e6, (3, 50, 34)).astype(np.float32)
    np.testing.assert_allclose(
        post_filter(torch.from_numpy(g), torch.from_numpy(ey)).numpy(),
        np.asarray(j_post_filter(jnp.asarray(g), jnp.asarray(ey))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("highpass", [False, True])
def test_augment_pair_equals_jax(featgen_goldens, highpass):
    clean = featgen_goldens["clean16"].astype(np.float32)
    noisy = featgen_goldens["noisy16"].astype(np.float32)
    ours = augment.augment_pair(clean, noisy, np.random.default_rng((3, 1)),
                                highpass=highpass)
    theirs = j_augment.augment_pair(clean, noisy,
                                    np.random.default_rng((3, 1)),
                                    highpass=highpass)
    for a, b in zip(ours, theirs):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_biquad_matches_reference_recurrence():
    """biquad == the C recurrence (denoise.cpp:361-370), as
    tests/test_featgen_parity.py holds JAX's."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(256).astype(np.float32) * 1000
    a, b = augment.rand_resp(rng)
    y = augment.biquad(x, b, a)
    m0 = m1 = 0.0
    ref = np.empty_like(x)
    for i in range(len(x)):
        yi = float(x[i]) + m0
        m0 = m1 + (b[0] * float(x[i]) - a[0] * yi)
        m1 = b[1] * float(x[i]) - a[1] * yi
        ref[i] = yi
    np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-4)


def test_batch_matches_single_pair():
    """generate_batch (one pass over many pairs) reproduces the
    single-pair path row for row."""
    rng = np.random.default_rng(12)
    count = 30
    n = count * 480
    cleans = [rng.normal(0, 3000, n).astype(np.float32) for _ in range(3)]
    # one short and one long signal: both are cut or padded to count
    cleans[1] = cleans[1][: n - 700]
    noisys = [np.concatenate([c, rng.normal(0, 3000, 500)]).astype(
        np.float32) + rng.normal(0, 1000, len(c) + 500).astype(np.float32)
              for c in cleans]
    batch = generate_batch(cleans, noisys, count, device=CPU)
    assert batch.shape == (3, count, RECORD_DIM)
    for i in range(3):
        single, test = generate_pair(cleans[i], noisys[i], count, device=CPU)
        assert test is None
        np.testing.assert_allclose(batch[i], single, rtol=2e-5, atol=2e-5)


def _pairs(tmp_path, n_pairs, count):
    rng = np.random.default_rng(9)
    lines = []
    for i in range(n_pairs):
        c = rng.normal(0, 3000, count * 480)
        n = c + rng.normal(0, 1000, c.shape)
        cp, np_ = tmp_path / f"c{i}.pcm", tmp_path / f"n{i}.pcm"
        c.astype("<i2").tofile(cp)
        n.astype("<i2").tofile(np_)
        lines.append(f"{cp} {np_}")
    pf = tmp_path / "pairs.txt"
    pf.write_text("\n".join(lines) + "\n")
    return str(pf)


def _featgen(pairs_file, out_dir, *extra):
    dispatcher.main(["featgen", "--pairs-file", pairs_file, "--out-dir",
                     str(out_dir), "--count", "6", "--device", CPU, *extra])
    return {p.name: np.fromfile(p, "<f4") for p in out_dir.glob("*.f32")}


def test_shards_partition_the_jobs(tmp_path):
    """--shard-id/--num-shards split the pairs file by job index, and the
    augmentation draws follow the job index, so the shards' records are
    the unsharded run's."""
    pf = _pairs(tmp_path, 5, 6)
    whole = _featgen(pf, tmp_path / "whole", "--augment", "--batch", "2")
    shards = [_featgen(pf, tmp_path / f"s{i}", "--augment", "--num-shards",
                       "2", "--shard-id", str(i)) for i in range(2)]
    assert sorted(whole) == [f"n{i}.f32" for i in range(5)]
    assert sorted(shards[0]) == ["n0.f32", "n2.f32", "n4.f32"]
    assert sorted(shards[1]) == ["n1.f32", "n3.f32"]
    for shard in shards:
        for name, rec in shard.items():
            assert rec.size == 6 * RECORD_DIM
            np.testing.assert_allclose(rec, whole[name], rtol=2e-5,
                                       atol=2e-5)


def test_skip_existing_resumes_by_signature(tmp_path, capsys):
    pf = _pairs(tmp_path, 2, 6)
    out = tmp_path / "out"
    _featgen(pf, out)
    assert (out / "n0.f32.meta").read_text().strip() == \
        "v1 augment=0 seed=0 highpass=0 postfilter=1"
    capsys.readouterr()
    _featgen(pf, out, "--skip-existing")
    assert "--skip-existing: 2/2 already done" in capsys.readouterr().out
    # other settings: nothing counts as done
    _featgen(pf, out, "--skip-existing", "--no-postfilter")
    assert "already done" not in capsys.readouterr().out
    assert (out / "n1.f32.meta").read_text().strip().endswith(
        "postfilter=0")
