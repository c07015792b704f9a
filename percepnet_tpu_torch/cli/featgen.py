"""Feature/label generation: the TRAINING=1 `percepNet` binary equivalent.

Usage (reference CLI shape, denoise.cpp:603-650):
  python -m percepnet_tpu_torch featgen clean.pcm noisy.pcm count out.f32
  python -m percepnet_tpu_torch featgen --pairs-file pairs.txt --out-dir feats/

Writes <count> frames of 138 float32 records per pair
(denoise.cpp:761-773): [Ey_look(34), Ephaty(34), T, pitch_corr, g(34),
r(34)].  Inputs are read at raw int16 amplitude (NORM_RATIO=1,
denoise.cpp:41), and the analysis runs in f32 on the card unless
--device cpu.  --test also writes the oracle-enhanced test_output.pcm /
test_input.pcm pair (the reference's built-in integration test,
denoise.cpp:742-759).

A pairs file has lines `clean.pcm noisy.pcm [count] [out.f32]`: pairs of
equal count are analyzed --batch at a time in one pass (the counterpart
of the 8-process shell fan-out, utils/run.sh:98-122), and
--shard-id/--num-shards split the jobs across processes or hosts.
"""

from __future__ import annotations

import argparse
import os
from itertools import groupby

import numpy as np
import torch

from percepnet_tpu_torch import constants as C
from percepnet_tpu_torch.enhance import enhance_spectra
from percepnet_tpu_torch.features import augment
from percepnet_tpu_torch.features.frontend import analyze_batch, \
    analyze_utterance
from percepnet_tpu_torch.features.labels import make_labels, make_records
from percepnet_tpu_torch.io.pcm import read_pcm16, write_pcm16
from percepnet_tpu_torch.ops.dispatch import resolve_device

RECORD_BYTES = C.RECORD_DIM * 4    # 138 float32 per frame


def _fit(x: np.ndarray, n: int) -> np.ndarray:
    """x cut or zero-padded to n samples, f32."""
    out = np.zeros(n, np.float32)
    m = min(len(x), n)
    out[:m] = x[:m]
    return out


@torch.no_grad()
def generate_pair(clean: np.ndarray, noisy: np.ndarray, count: int, *,
                  apply_postfilter: bool = True, oracle: bool = False,
                  device: str | torch.device | None = None):
    """(records [count, 138] numpy, oracle dict or None) for one pair."""
    dev = resolve_device(device)
    n = count * C.FRAME_SIZE
    clean, noisy = _fit(clean, n), _fit(noisy, n)
    clean_out, _ = analyze_utterance(torch.from_numpy(clean).to(dev))
    noisy_out, _ = analyze_utterance(torch.from_numpy(noisy).to(dev))
    records = make_records(clean_out, noisy_out,
                           apply_postfilter=apply_postfilter)
    test = None
    if oracle:
        lab = make_labels(clean_out, noisy_out,
                          apply_postfilter=apply_postfilter)
        pcm, _ = enhance_spectra({k: v[None] for k, v in noisy_out.items()},
                                 lab["g"][None], lab["r"][None])
        test = {"output": pcm[0].cpu().numpy(), "input": noisy}
    return records.cpu().numpy(), test


@torch.no_grad()
def generate_batch(cleans, noisys, count: int, *,
                   apply_postfilter: bool = True,
                   device: str | torch.device | None = None) -> np.ndarray:
    """Records of equal-count pairs analyzed in one batched pass each for
    the clean and the noisy streams: [n_pairs, count, 138] numpy."""
    dev = resolve_device(device)
    n = count * C.FRAME_SIZE

    def stack(sigs):
        return torch.from_numpy(np.stack([_fit(s, n) for s in sigs])).to(dev)

    clean_out, _ = analyze_batch(stack(cleans))
    noisy_out, _ = analyze_batch(stack(noisys))
    return make_records(clean_out, noisy_out,
                        apply_postfilter=apply_postfilter).cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m percepnet_tpu_torch featgen",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("args", nargs="*",
                    help="clean.pcm noisy.pcm count out.f32")
    ap.add_argument("--pairs-file", help="file of: clean noisy [count] [out]")
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--count", type=int, default=2000,
                    help="frames per pair (run.sh uses 2000)")
    ap.add_argument("--no-postfilter", action="store_true",
                    help="dump un-postfiltered gains (see features.labels)")
    ap.add_argument("--test", action="store_true",
                    help="also write oracle test_output.pcm/test_input.pcm")
    ap.add_argument("--shard-id", type=int, default=0)
    ap.add_argument("--num-shards", type=int, default=1)
    ap.add_argument("--batch", type=int, default=16,
                    help="pairs analyzed per pass (not with --test)")
    ap.add_argument("--augment", action="store_true",
                    help="random level gain + biquad channel response per "
                         "pair (the reference's dormant augmentation, "
                         "denoise.cpp:670-718; see features.augment)")
    ap.add_argument("--augment-seed", type=int, default=0)
    ap.add_argument("--augment-highpass", action="store_true",
                    help="with --augment: also the fixed DC high-pass")
    ap.add_argument("--skip-existing", action="store_true",
                    help="skip pairs whose output .f32 already exists at "
                         "the full size AND whose .meta sidecar records the "
                         "same generation settings (resumes a killed sweep; "
                         "augment draws stay per job index, so the records "
                         "equal an uninterrupted run's; files without a "
                         "sidecar are regenerated)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # Generation-settings signature, written to a `<out>.meta` sidecar so
    # --skip-existing never mixes records made under other flags (or an
    # older record format) into one training set; the JAX package writes
    # the same one, so either package resumes the other's sweep.
    sig = "v1 augment=%d seed=%d highpass=%d postfilter=%d" % (
        args.augment, args.augment_seed, args.augment_highpass,
        not args.no_postfilter)

    jobs = []
    if args.pairs_file:
        with open(args.pairs_file) as f:
            for ln in f:
                parts = ln.split()
                if not parts:
                    continue
                clean, noisy = parts[0], parts[1]
                cnt = int(parts[2]) if len(parts) > 2 else args.count
                out = parts[3] if len(parts) > 3 else os.path.join(
                    args.out_dir,
                    os.path.splitext(os.path.basename(noisy))[0] + ".f32")
                jobs.append((clean, noisy, cnt, out))
    else:
        if len(args.args) != 4:
            ap.error("expected: clean.pcm noisy.pcm count out.f32")
        jobs.append((args.args[0], args.args[1], int(args.args[2]),
                     args.args[3]))
    dev = resolve_device(args.device)
    # job index BEFORE sharding, so augmentation draws are shard-invariant
    jobs = [(i,) + j for i, j in enumerate(jobs)]
    jobs = jobs[args.shard_id :: args.num_shards]
    if args.skip_existing:
        def is_done(j):
            if not (os.path.isfile(j[4])
                    and os.path.getsize(j[4]) == j[3] * RECORD_BYTES):
                return False
            try:
                with open(j[4] + ".meta") as f:
                    return f.read().strip() == sig
            except OSError:
                return False    # no sidecar: unknown settings, regenerate
        done = [j for j in jobs if is_done(j)]
        if done:
            print(f"--skip-existing: {len(done)}/{len(jobs)} already done")
        jobs = [j for j in jobs if j not in set(done)]

    def write_records(records, out_p):
        records.astype(np.float32).tofile(out_p)
        with open(out_p + ".meta", "w") as f:
            f.write(sig + "\n")

    def load_pair(idx, clean_p, noisy_p):
        clean, noisy = read_pcm16(clean_p), read_pcm16(noisy_p)
        if not args.augment:
            return clean, noisy
        rng = np.random.default_rng((args.augment_seed, idx))
        return augment.augment_pair(clean, noisy, rng,
                                    highpass=args.augment_highpass)

    os.makedirs(args.out_dir, exist_ok=True)
    postfilter = not args.no_postfilter
    if args.batch > 1 and not args.test and len(jobs) > 1:
        # equal-count jobs in batched passes (one shape per count)
        for cnt, group in groupby(sorted(jobs, key=lambda j: j[3]),
                                  key=lambda j: j[3]):
            group = list(group)
            for i in range(0, len(group), args.batch):
                chunk = group[i : i + args.batch]
                pairs = [load_pair(idx, c, n) for idx, c, n, _, _ in chunk]
                recs = generate_batch([p[0] for p in pairs],
                                      [p[1] for p in pairs], cnt,
                                      apply_postfilter=postfilter,
                                      device=dev)
                for rec, job in zip(recs, chunk):
                    write_records(rec, job[4])
                print(f"{chunk[0][4]} .. {chunk[-1][4]}: "
                      f"{len(chunk)} x {cnt} frames", flush=True)
        return
    for idx, clean_p, noisy_p, cnt, out_p in jobs:
        clean, noisy = load_pair(idx, clean_p, noisy_p)
        records, test = generate_pair(clean, noisy, cnt,
                                      apply_postfilter=postfilter,
                                      oracle=args.test, device=dev)
        write_records(records, out_p)
        print(f"{out_p}: {records.shape[0]} frames")
        if test is not None:
            base = os.path.dirname(out_p) or "."
            write_pcm16(os.path.join(base, "test_output.pcm"),
                        test["output"])
            write_pcm16(os.path.join(base, "test_input.pcm"), test["input"])


if __name__ == "__main__":
    main()
