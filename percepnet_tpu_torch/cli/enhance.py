"""Enhance PCM files: the `percepNet_run` equivalent (main.cpp:11-41).

Usage:
  python -m percepnet_tpu_torch enhance noisy.pcm out.pcm --weights model.npz
  python -m percepnet_tpu_torch enhance a.pcm b.pcm ... --out-dir enhanced/

Weights: a flat params .npz or a TrainState checkpoint .npz (either
package's), a PyTorch state_dict .pt/.pth from rnn_train.py, or a
generated nnet_data.cpp.  Input and output: raw 48 kHz mono s16le PCM.
Runs on the card unless --device cpu.

Faithful quirks, both on by default to match the reference byte stream:
  * input scaled /32768 (main.cpp:34);
  * the first output frame is dropped (main.cpp:37-38), so output lags
    input by FRAME_LOOKAHEAD+1 frames and is one frame shorter.
Pass --keep-first-frame to keep it.

Files are batched together (padded to the longest) and enhanced in
--batch-frames chunks with the carried pipeline state.
"""

from __future__ import annotations

import argparse
import copy
import os
import time

import numpy as np
import torch

from percepnet_tpu_torch import constants as C
from percepnet_tpu_torch import pipeline
from percepnet_tpu_torch.io.pcm import read_pcm16, write_pcm16
from percepnet_tpu_torch.models.percepnet import PercepNet
from percepnet_tpu_torch.ops.activations import sigmoid_approx, tansig_approx
from percepnet_tpu_torch.ops.dispatch import resolve_device

LATENCY_STEPS = 50


def load_params(path: str) -> PercepNet:
    """A CPU PercepNet from .npz (flat or TrainState), .pt/.pth
    (rnn_train.py state_dict) or a generated nnet_data .cpp."""
    if path.endswith(".npz"):
        from percepnet_tpu_torch.io.flat_npz import load_params as load_npz
        return load_npz(path)
    if path.endswith((".pt", ".pth")):
        from percepnet_tpu_torch.io.torch_import import model_from_state_dict
        return model_from_state_dict(
            torch.load(path, map_location="cpu", weights_only=True))
    if path.endswith(".cpp"):
        from percepnet_tpu_torch.io.nnet_data import model_from_nnet_data_cpp
        return model_from_nnet_data_cpp(path)
    raise ValueError(f"unknown weight format: {path}")


def _prepare(model: PercepNet, dev: torch.device, compat: bool,
             model_dtype, log1p_features: bool):
    """The model on `dev` in the tier's dtype (a bf16 copy for the bf16
    tier, cast once) and enhance_chunk's model keywords."""
    kw = {}
    if compat:
        kw.update(act_tanh=tansig_approx, act_sigmoid=sigmoid_approx)
    if log1p_features:
        # must match the checkpoint's training config (log1p_features)
        kw["log1p_features"] = True
    model = model.to(dev)
    if model_dtype == torch.bfloat16:
        kw["compute_dtype"] = model_dtype
        model = copy.deepcopy(model).to(model_dtype)
    return model, kw


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def enhance_files(model: PercepNet, in_paths, out_paths, *,
                  batch_frames: int = 2000, drop_first_frame: bool = True,
                  compat: bool = False, dump_gr_paths=None, model_dtype=None,
                  raw_scale: bool = False, log1p_features: bool = False,
                  device: str | torch.device | None = None) -> None:
    """Enhance files batched together, in chunks of batch_frames frames.

    raw_scale: feed raw int16 amplitudes instead of /32768.  The
    reference's two binaries disagree on scale: featgen reads raw
    amplitudes (NORM_RATIO=1, denoise.cpp:41) while percepNet_run divides
    by 32768 (main.cpp:34), and the band-energy and pitch-coherence
    features are not scale-invariant.  False is percepNet_run's behaviour
    (the parity surface); True matches the training data's scale, which a
    checkpoint trained on featgen records needs.
    model_dtype: torch.bfloat16 selects the bf16 serving tier.
    """
    dev = resolve_device(device)
    model, kw = _prepare(model, dev, compat, model_dtype, log1p_features)
    pcm_scale = 1.0 if raw_scale else 32768.0
    signals = [read_pcm16(p, normalize=not raw_scale) for p in in_paths]
    n_frames = [len(s) // C.FRAME_SIZE for s in signals]
    bsz = len(signals)

    dump_gr = dump_gr_paths is not None
    state = pipeline.init_pipeline_state(
        bsz, model_dtype=model_dtype or torch.float32, device=dev)
    chunk = batch_frames * C.FRAME_SIZE
    max_len = max(n_frames) * C.FRAME_SIZE
    # drain the lookahead with zero frames at the end
    total = max_len + pipeline.flush_frames() * C.FRAME_SIZE
    total = -(-total // chunk) * chunk

    outs = [[] for _ in signals]
    grs = [[] for _ in signals]
    for start in range(0, total, chunk):
        block = np.zeros((bsz, chunk), np.float32)
        for i, s in enumerate(signals):
            seg = s[start : start + chunk]
            block[i, : len(seg)] = seg
        res = pipeline.enhance_chunk(model, block, state, return_gr=dump_gr,
                                     device=dev, **kw)
        pcm, state = res[0], res[1]
        if dump_gr:
            g, r = res[2]
            gr = torch.cat([g, r], dim=-1).cpu().numpy()
            for i in range(bsz):
                grs[i].append(gr[i])
        pcm = pcm.cpu().numpy()
        for i in range(bsz):
            outs[i].append(pcm[i])

    for i, (path, nf) in enumerate(zip(out_paths, n_frames)):
        y = np.concatenate(outs[i])
        skip = C.FRAME_SIZE if drop_first_frame else 0
        keep = nf * C.FRAME_SIZE - skip
        write_pcm16(path, y[skip : skip + keep], scale=pcm_scale)
        if dump_gr:
            # the reference's feature_test.raw: per processed frame, 34 g
            # then 34 r float32 (denoise.cpp:533-534), one record per
            # INPUT frame (none dropped), one file per input
            np.concatenate(grs[i])[:nf].astype("<f4").tofile(
                dump_gr_paths[i])


def enhance_streaming(model: PercepNet, in_path: str, out_path: str, *,
                      drop_first_frame: bool = True, compat: bool = False,
                      model_dtype=None, raw_scale: bool = False,
                      log1p_features: bool = False,
                      report_latency: bool = False,
                      device: str | torch.device | None = None):
    """Frame-by-frame streaming enhancement (10 ms hop), like the
    reference binary's loop (main.cpp:30-39): one enhance_chunk per frame
    with the carried state.  Algorithmic latency is the reference's 60 ms
    (lookahead) plus the per-frame compute time.

    The whole signal is staged on the device once and each step takes a
    view of its frame there, so the loop copies nothing from the host; a
    live-capture caller would feed frames instead (file replay is the
    latency harness).  Returns the steady-state per-frame step time in ms
    with report_latency (each step waited for), else None.
    """
    dev = resolve_device(device)
    model, kw = _prepare(model, dev, compat, model_dtype, log1p_features)
    state_dtype = model_dtype or torch.float32
    signal = read_pcm16(in_path, normalize=not raw_scale)
    n_frames = len(signal) // C.FRAME_SIZE
    total = n_frames + pipeline.flush_frames()

    sig_dev = torch.zeros(total * C.FRAME_SIZE, dtype=torch.float32,
                          device=dev)
    sig_dev[: len(signal)] = torch.from_numpy(signal)

    def step(t, st):
        t %= total
        frame = sig_dev[t * C.FRAME_SIZE : (t + 1) * C.FRAME_SIZE][None]
        return pipeline.enhance_chunk(model, frame, st, device=dev, **kw)

    def fresh():
        return pipeline.init_pipeline_state(1, model_dtype=state_dtype,
                                            device=dev)

    state = fresh()
    # outputs stay on the device until the end: no per-frame sync
    outs = []
    for t in range(total):
        pcm, state = step(t, state)
        outs.append(pcm[0])
    y = torch.cat(outs).cpu().numpy()
    skip = C.FRAME_SIZE if drop_first_frame else 0
    write_pcm16(out_path, y[skip : skip + n_frames * C.FRAME_SIZE - skip],
                scale=1.0 if raw_scale else 32768.0)
    if not report_latency:
        return None
    # steady-state wall time per step, waiting for the device at both
    # ends: without the waits it would time only the enqueueing
    st = fresh()
    _, st = step(0, st)
    _sync(dev)
    t0 = time.perf_counter()
    for t in range(1, LATENCY_STEPS + 1):
        _, st = step(t, st)
    _sync(dev)
    ms = (time.perf_counter() - t0) / LATENCY_STEPS * 1e3
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"per-frame step time: {ms:.3f} ms on {where} "
          f"(budget 10.0 for real-time 48 kHz)", flush=True)
    return ms


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m percepnet_tpu_torch enhance",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("pcm", nargs="+",
                    help="noisy.pcm out.pcm | inputs... with --out-dir")
    ap.add_argument("--weights", required=True)
    ap.add_argument("--out-dir")
    ap.add_argument("--batch-frames", type=int, default=2000)
    ap.add_argument("--keep-first-frame", action="store_true",
                    help="disable the reference's dropped first frame")
    ap.add_argument("--compat", action="store_true",
                    help="use the C inference tansig/sigmoid tables")
    ap.add_argument("--bf16", action="store_true",
                    help="the bf16 serving tier")
    ap.add_argument("--log1p", action="store_true",
                    help="log1p feature compression at the model input, "
                         "required for checkpoints trained with "
                         "log1p_features")
    ap.add_argument("--raw-scale", action="store_true",
                    help="feed raw int16 amplitudes (the featgen/training "
                         "scale) instead of the reference binary's /32768, "
                         "required for checkpoints trained on featgen "
                         "records; see enhance_files")
    ap.add_argument("--dump-gr", nargs="?", const="feature_test.raw",
                    metavar="PATH",
                    help="dump per-frame g,r (34+34 float32/frame) like the "
                         "reference's feature_test.raw side channel "
                         "(denoise.cpp:533-534); with --out-dir, one "
                         "<name>.gr.raw per input")
    ap.add_argument("--streaming", action="store_true",
                    help="frame-by-frame real-time mode (one 10 ms frame "
                         "per step, carried state)")
    ap.add_argument("--report-latency", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.out_dir:
        ins = args.pcm
        os.makedirs(args.out_dir, exist_ok=True)
        outs = [os.path.join(args.out_dir, os.path.basename(p)) for p in ins]
    else:
        if len(args.pcm) != 2:
            ap.error("expected: noisy.pcm out.pcm (or use --out-dir)")
        ins, outs = [args.pcm[0]], [args.pcm[1]]

    gr_paths = None
    if args.dump_gr:
        if args.streaming:
            ap.error("--dump-gr is only supported in batch mode")
        if args.out_dir:
            gr_paths = [os.path.join(
                args.out_dir, os.path.basename(p) + ".gr.raw") for p in ins]
        else:
            gr_paths = [args.dump_gr]

    dev = resolve_device(args.device)
    model = load_params(args.weights)
    model_dtype = torch.bfloat16 if args.bf16 else None
    common = dict(drop_first_frame=not args.keep_first_frame,
                  compat=args.compat, model_dtype=model_dtype,
                  raw_scale=args.raw_scale, log1p_features=args.log1p,
                  device=dev)
    if args.streaming:
        for i, o in zip(ins, outs):
            enhance_streaming(model, i, o,
                              report_latency=args.report_latency, **common)
    else:
        enhance_files(model, ins, outs, batch_frames=args.batch_frames,
                      dump_gr_paths=gr_paths, **common)


if __name__ == "__main__":
    main()
