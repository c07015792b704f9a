"""Batched analysis front-end: PCM -> spectra, band energies, pitch, comb.

The reference processes one 10 ms frame at a time through ring buffers
inside DenoiseState (denoise.cpp:61-85, 372-434).  Every one of those
buffers is a sliding window over the input signal, so, as in the JAX
package, they become offsets into one left-padded signal and all frames
of a chunk are computed at once:

  padded index of frame t = t*FRAME_SIZE + OFFSET, with OFFSET:
    analysis window (X)       2400   (denoise.cpp:402: the frame being
                                      enhanced lags the input by
                                      FRAME_LOOKAHEAD+1 frames)
    comb-filter base          2400 - pitch*k   (denoise.cpp:419-422)
    pitch buffer               1632   (denoise.cpp:396-397)
    lookahead window           4800   (denoise.cpp:498-506)

Only the remove_doubling hysteresis (ops.pitch.pitch_track_ds) and,
downstream, the GRU state are sequential across frames.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from percepnet_tpu_torch import constants as C
from percepnet_tpu_torch.ops import bands, comb, dft, pitch, window
from percepnet_tpu_torch.ops.dispatch import resolve_impl

PAD = C.COMB_BUF_SIZE - C.FRAME_SIZE  # 5280 zeros: the initial ring state
_X_OFF = 2400
_PITCH_OFF = 1632


class FrontendState(NamedTuple):
    """Streaming carry-over between chunks, for B streams.

    tail:   [B, PAD] f32 last samples of the previous chunk (ring buffers).
    period: [B] int32 last pitch period (DenoiseState.last_period).
    gain:   [B] f32 last pitch gain (DenoiseState.last_gain).
    """
    tail: torch.Tensor
    period: torch.Tensor
    gain: torch.Tensor


def init_state(batch: int, device: torch.device) -> FrontendState:
    return FrontendState(
        tail=torch.zeros((batch, PAD), dtype=torch.float32, device=device),
        period=torch.zeros((batch,), dtype=torch.int32, device=device),
        gain=torch.zeros((batch,), dtype=torch.float32, device=device))


def analyze_batch(signal: torch.Tensor, state: FrontendState | None = None,
                  *, serving: bool = False, impl: str | None = None):
    """Analyze a batch of chunks; returns per-frame features and spectra.

    Args:
      signal: [B, n_samples] f32 PCM (n_samples a multiple of FRAME_SIZE)
        on the device the analysis runs on.  /32768 scale for inference
        (main.cpp:34).
      state: streaming carry (None = fresh DenoiseState zeros).
      serving: the bf16 serving tier: the windowed frames and the comb
        output (stored bf16 by the kernel) enter the DFT as bf16, with f32
        spectra out (ops.dft).  The pitch search stays f32: the JAX
        package's bf16 pitch contractions exist only in its TPU layouts,
        and its CPU tier, which the port follows, ignores them, so the
        periods equal the f32 tier's.  Default False: the parity path.
      impl: 'ref' / 'cuda' tier for the comb filter; None takes the tier
        of signal's device (ops.dispatch).

    Returns:
      (out, new_state) where out is a dict of [B, T, ...] tensors:
        xr, xi      [B, T, 481]  spectrum of the (delayed) enhanced frame
        pr, pi      [B, T, 481]  comb-filtered spectrum
        ex, ep      [B, T, 34]   band energies of X and P
        exp         [B, T, 34]   clamped pitch coherence  (denoise.cpp:427)
        ey_look     [B, T, 34]   lookahead band energy    (denoise.cpp:498)
        period      [B, T] int32, gain [B, T], corr [B, T]  pitch track
        silence     [B, T] bool  (sum Ex < 0.1, denoise.cpp:429-433)
        features    [B, T, 70]   model input (create_features, :487)
    """
    impl = resolve_impl(impl, signal.device)
    bsz, n = signal.shape
    if n % C.FRAME_SIZE or n == 0:
        raise ValueError(f"chunk length {n} is not a positive multiple of "
                         f"{C.FRAME_SIZE}")
    if state is None:
        state = init_state(bsz, signal.device)
    n_frames = n // C.FRAME_SIZE
    s_pad = torch.cat([state.tail, signal.to(torch.float32)], dim=-1)

    # --- spectra of the frame being enhanced -----------------------------
    # The lookahead window of frame t (offset 4800) covers the samples of
    # the analysis window of frame t+5, so ONE pass over T+5 frames gives
    # both the X spectra (rows :T) and the lookahead energies (rows 5:).
    frames = s_pad[:, _X_OFF:].unfold(-1, C.WINDOW_SIZE, C.FRAME_SIZE)
    xw = window.apply_window(frames)
    if serving:
        xw = xw.to(torch.bfloat16)
    xr_ext, xi_ext = dft.forward_dft(xw)
    ex_ext = bands.band_energy(xr_ext, xi_ext)
    xr, xi = xr_ext[:, :n_frames], xi_ext[:, :n_frames]
    ex = ex_ext[:, :n_frames]

    # --- pitch track ------------------------------------------------------
    ds = pitch.downsample_frames_from_stream(s_pad, n_frames, _PITCH_OFF)
    track = pitch.pitch_track_ds(ds, state.period, state.gain)
    period = track["period"]

    # --- comb filter (CUDA kernel on the card; window applied inside) ----
    # serving tier: the kernel stores bf16, the DFT's operand type
    pw = comb.comb_filter_windows_batch(
        s_pad, period, _X_OFF,
        out_dtype=torch.bfloat16 if serving else torch.float32, impl=impl)
    pr, pi = dft.forward_dft(pw)
    ep = bands.band_energy(pr, pi)
    exp_raw = bands.band_corr(xr, xi, pr, pi)
    exp = torch.clamp(exp_raw / torch.sqrt(1e-15 + ex * ep), 0.0, 1.0)

    silence = torch.sum(ex, dim=-1) < 0.1

    # --- lookahead energy + feature vector -------------------------------
    ey_look = ex_ext[:, C.FRAME_LOOKAHEAD:]
    t_feat = period.to(torch.float32) / C.PITCH_T_NORM
    features = torch.cat([
        ey_look * C.FEATURE_SCALE,
        exp * C.FEATURE_SCALE,
        t_feat[..., None],
        track["corr"][..., None],
    ], dim=-1)

    new_state = FrontendState(
        tail=s_pad[:, -PAD:].contiguous(),
        period=track["final_period"],
        gain=track["final_gain"])
    out = dict(xr=xr, xi=xi, pr=pr, pi=pi, ex=ex, ep=ep, exp=exp,
               ey_look=ey_look, period=period, gain=track["gain"],
               corr=track["corr"], silence=silence, features=features)
    return out, new_state
