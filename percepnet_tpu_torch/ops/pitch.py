"""CELT/Opus pitch stack, batched over frames (pitch.cpp, celt_lpc.cpp).

A port of the JAX package's 'cpu' tier: the reduction orders its strict
parity goldens were validated on.  For all frames at once:
  * 2x decimation and order-4 LPC whitening (downsample_frames_from_stream),
    its autocorrelation summed in the JAX package's order (_tree_sum);
  * the full lag-0..384 autocorrelation of each frame as one grouped
    correlation (F.conv1d with one group per frame); the fine search and
    every lag lookup in remove_doubling read from it with torch.gather;
  * window energies as differences of a prefix sum taken in the JAX
    package's order (_prefix_sum), which borderline pitch decisions
    depend on;
  * the top-2 coarse/fine search as argmax over lag scores;
  * remove_doubling as a frame-parallel precompute plus a hysteresis
    loop over frames — the only sequential part, batched over streams and
    kept on the device (no host sync per frame).

Geometry (all static): PITCH_BUF_SIZE=1728 -> ds len 864; x_lp = ds[384:]
(480 samples); max_pitch = 588; coarse lags 147, fine lags 294;
half-domain max period 384.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from percepnet_tpu_torch import constants as C

_DS_LEN = C.PITCH_BUF_SIZE // 2          # 864
_X_OFF = C.PITCH_MAX_PERIOD // 2         # 384
_X_LEN = _DS_LEN - _X_OFF                # 480
_MAX_PITCH = C.PITCH_MAX_PERIOD - 3 * C.PITCH_MIN_PERIOD   # 588
_COARSE_LAGS = _MAX_PITCH >> 2           # 147
_FINE_LAGS = _MAX_PITCH >> 1             # 294
_MAX_PERIOD_H = C.PITCH_MAX_PERIOD // 2  # 384
_MIN_PERIOD_H = C.PITCH_MIN_PERIOD // 2  # 30

# remove_doubling's subharmonic re-check table (pitch.cpp:423)
_SECOND_CHECK = (0, 0, 3, 2, 3, 2, 5, 2, 3, 2, 3, 2, 5, 2, 3, 2)


@functools.lru_cache(maxsize=None)
def _second_check_table() -> np.ndarray:
    """_SECOND_CHECK at k = 2..15."""
    return np.asarray(_SECOND_CHECK[2:], np.int64)


# block lengths of the JAX package's CPU summation orders (_tree_sum,
# _prefix_sum)
_SUM_BLOCK = 32
_SCAN_BLOCK = 16


def _batched_corr(sig: torch.Tensor, ker: torch.Tensor,
                  out_len: int) -> torch.Tensor:
    """out[n, i] = sum_j ker[n, j] * sig[n, i + j] for i < out_len.

    sig [N, L], ker [N, K]: one grouped correlation, a group per row
    (F.conv1d is a correlation; TF32 is off for it, see the package).
    """
    n = sig.shape[0]
    out = F.conv1d(sig[None], ker[:, None, :], groups=n)
    return out[0, :, :out_len]


# --------------------------------------------------------------------------
# pitch_downsample: 2x decimation + LPC whitening (pitch.cpp:148-216)
# --------------------------------------------------------------------------

def _sequential_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, added left to right."""
    acc = x[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def _block_pad(n: int) -> tuple[int, int]:
    """Zeros before and after n values to fill whole blocks of _SUM_BLOCK."""
    pad = -(-n // _SUM_BLOCK) * _SUM_BLOCK - n
    return pad // 2, pad - pad // 2


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """f32 sum over the last axis in the order the JAX package's jnp.sum
    takes on the CPU: zero-pad to whole blocks of 32 (split before and
    after), add each block left to right, then sum the block sums the same
    way.  The whitening filter, and through it the pitch decisions,
    inherit this order."""
    n = x.shape[-1]
    if n <= _SUM_BLOCK:
        return _sequential_sum(x)
    xp = F.pad(x, _block_pad(n))
    return _tree_sum(_sequential_sum(xp.reshape(*x.shape[:-1], -1,
                                                _SUM_BLOCK)))


def _autocorr5(ds: torch.Tensor) -> torch.Tensor:
    """ac[..., k] = sum_{i>=k} ds[i]*ds[i-k], k < 5, by _tree_sum.  The
    five products, each padded to whole blocks as _tree_sum would pad it,
    are summed as one stacked tensor: at the 864-sample frame they all
    pad to 864."""
    n = ds.shape[-1]
    prods = [ds * ds] + [ds[..., k:] * ds[..., : n - k] for k in range(1, 5)]
    return _tree_sum(torch.stack(
        [F.pad(p, _block_pad(p.shape[-1])) for p in prods], dim=-2))


def _levinson4(ac: torch.Tensor) -> torch.Tensor:
    """Order-4 Levinson-Durbin, unrolled, batched over leading dims.

    Mirrors _celt_lpc (celt_lpc.cpp:37-88) float path including the 1e-5
    division guard and the 30 dB early exit (error < .001*ac[0]): once the
    exit triggers, later coefficients keep their pre-exit values.

    Args:  ac [..., 5] autocorrelation (already noise-floored/lag-windowed).
    Returns: lpc [..., 4].
    """
    ac0 = ac[..., 0]
    lpc = [torch.zeros_like(ac0) for _ in range(4)]
    error = ac0
    done = ac0 == 0
    for i in range(4):
        rr = ac[..., i + 1]
        for j in range(i):
            rr = rr + lpc[j] * ac[..., i - j]
        r = -rr / (error + 1e-5)
        new = list(lpc)
        new[i] = r
        for j in range((i + 1) >> 1):
            t1, t2 = lpc[j], lpc[i - 1 - j]
            new[j] = t1 + r * t2
            new[i - 1 - j] = t2 + r * t1
        lpc = [torch.where(done, a, b) for a, b in zip(lpc, new)]
        error = torch.where(done, error, error - r * r * error)
        done = done | (error < 0.001 * ac0)
    return torch.stack(lpc, dim=-1)


def _whiten(ds: torch.Tensor) -> torch.Tensor:
    """[..., 864] decimated signal -> LPC-whitened (pitch.cpp:160-216).

    5-lag autocorrelation with noise floor (*1.0001) and lag windowing,
    order-4 LPC, 0.9^i bandwidth expansion, add-a-zero -> 5-tap FIR.
    """
    n = ds.shape[-1]
    ac = _autocorr5(ds)
    steps = torch.arange(1, 5, dtype=torch.float32, device=ds.device)
    lagw = 1.0 - (0.008 * steps) ** 2
    ac = torch.cat([ac[..., :1] * 1.0001, ac[..., 1:] * lagw], dim=-1)

    lpc = _levinson4(ac)
    lpc = lpc * (0.9 ** steps)            # bandwidth expansion
    c1 = 0.8
    num = torch.stack([
        lpc[..., 0] + c1,
        lpc[..., 1] + c1 * lpc[..., 0],
        lpc[..., 2] + c1 * lpc[..., 1],
        lpc[..., 3] + c1 * lpc[..., 2],
        c1 * lpc[..., 3],
    ], dim=-1)

    # celt_fir5: y[i] = ds[i] + sum_m num[m] * ds[i-1-m], taps added in
    # order m = 0..4 from one zero-padded buffer
    dsp = F.pad(ds, (5, 0))
    y = ds
    for m in range(5):
        y = y + num[..., m : m + 1] * dsp[..., 4 - m : 4 - m + n]
    return y


def _decimate(x: torch.Tensor) -> torch.Tensor:
    """2x decimation with the [.25 .5 .25] smoother, zero history."""
    even = x[..., 0::2]
    odd = x[..., 1::2]
    prev_odd = torch.cat([torch.zeros_like(odd[..., :1]), odd[..., :-1]],
                         dim=-1)
    return 0.25 * (prev_odd + odd) + 0.5 * even


def pitch_downsample(x: torch.Tensor) -> torch.Tensor:
    """[..., 1728] pitch buffer -> [..., 864] decimated + whitened signal
    (pitch.cpp:148-216)."""
    return _whiten(_decimate(x))


def downsample_frames_from_stream(s_pad: torch.Tensor, n_frames: int,
                                  offset: int) -> torch.Tensor:
    """[B, n_pad] signal -> [B, T, 864] decimated+whitened pitch frames.

    Equivalent to pitch_downsample over per-frame [1728] buffers at
    `offset + t*480`, but decimates the stream once and frames it at hop
    240.  Column 0 of each frame is patched to the buffer-boundary value
    (.25*x[1] + .5*x[0], the reference's zero-history start), so the
    decimated frames are bit-identical to the per-buffer path.
    """
    ds_stream = _decimate(s_pad)
    end = offset + (n_frames - 1) * C.FRAME_SIZE + 2
    xe = s_pad[..., offset:end:C.FRAME_SIZE]
    xo = s_pad[..., offset + 1:end:C.FRAME_SIZE]
    col0 = 0.25 * xo + 0.5 * xe

    hop2 = C.FRAME_SIZE // 2
    off2 = offset // 2
    need = off2 + (n_frames - 1) * hop2 + _DS_LEN
    if ds_stream.shape[-1] < need:
        ds_stream = F.pad(ds_stream, (0, need - ds_stream.shape[-1]))
    dsf = ds_stream[..., off2:need].unfold(-1, _DS_LEN, hop2)  # [B, T, 864]
    dsf = torch.cat([col0[..., None], dsf[..., 1:]], dim=-1)
    return _whiten(dsf)


# --------------------------------------------------------------------------
# find_best_pitch (pitch.cpp:46-104), vectorized top-2
# --------------------------------------------------------------------------

def _sequential_prefix(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis, added left to right."""
    cols = [x[..., 0]]
    for j in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., j])
    return torch.stack(cols, dim=-1)


def _prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix sum along the last axis, in the order the JAX
    package's cumsum takes on the CPU: left to right within blocks of 16,
    plus the prefix (taken the same way, recursively) of the block totals
    before each block.  torch.cumsum accumulates in double on the CPU,
    which rounds differently and flips borderline pitch decisions."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        return _sequential_prefix(x)
    m = -(-n // _SCAN_BLOCK)
    xp = F.pad(x, (0, m * _SCAN_BLOCK - n))
    inner = _sequential_prefix(xp.reshape(*x.shape[:-1], m, _SCAN_BLOCK))
    totals = _prefix_sum(inner[..., -1])
    before = torch.cat([torch.zeros_like(totals[..., :1]), totals[..., :-1]],
                       dim=-1)
    out = inner + before[..., None]
    return out.reshape(*x.shape[:-1], m * _SCAN_BLOCK)[..., :n]


def _window_energy(y: torch.Tensor, length: int, n_out: int) -> torch.Tensor:
    """W[n, j] = sum_{i<length} y[n, j+i]^2 for j < n_out, as a difference
    of prefix sums (the reduction order the parity goldens need)."""
    c = _prefix_sum(y * y)
    c = torch.cat([torch.zeros_like(c[..., :1]), c], dim=-1)
    return c[..., length : length + n_out] - c[..., :n_out]


def _find_best_pitch(xcorr: torch.Tensor, y: torch.Tensor, length: int,
                     den: torch.Tensor | None = None):
    """Top-2 lags by normalized correlation score.

    Mirrors find_best_pitch: score_i = (xcorr_i*1e-12)^2 / Syy_i for
    xcorr_i > 0, earliest index wins ties; unconsidered lags keep the C
    code's initial best_pitch = [0, 1].

    Args:  xcorr [N, M] lag correlations, y [N, >= M+length] signal,
           den: optional precomputed sliding energies.
    Returns: (best0, best1) int64 [N].
    """
    m = xcorr.shape[-1]
    if den is None:
        den = torch.clamp(1.0 + _window_energy(y, length, m), min=1.0)
    considered = xcorr > 0
    num = torch.square(xcorr * 1e-12)
    score = torch.where(considered, num / den, -1.0)
    cnt = considered.sum(dim=-1)

    i0 = torch.argmax(score, dim=-1)
    iota = torch.arange(m, device=xcorr.device)
    score2 = torch.where(iota[None, :] == i0[:, None], -2.0, score)
    i1 = torch.argmax(score2, dim=-1)

    best0 = torch.where(cnt > 0, i0, 0)
    best1 = torch.where(cnt >= 2, i1, torch.where(cnt == 1, 0, 1))
    return best0, best1


# --------------------------------------------------------------------------
# pitch_search (pitch.cpp:283-386)
# --------------------------------------------------------------------------

def full_xcorr(ds: torch.Tensor) -> torch.Tensor:
    """xc_all[n, L] = sum_{j<480} ds[n, 384+j] * ds[n, 384-L+j], L <= 384.

    Its reversed output doubles as the reference's fine-search inner
    products (fine_xcorr[i] = xc_all[384-i]) and as every lag lookup in
    remove_doubling.
    """
    rev = _batched_corr(ds, ds[..., _X_OFF:], _MAX_PERIOD_H + 1)
    return rev.flip(-1)


def forward_window_energies(ds: torch.Tensor) -> torch.Tensor:
    """W[n, j] = sum_{i<480} ds[n, j+i]^2 for j <= 384 (shared by the yy
    lookup and the fine-search energies)."""
    return _window_energy(ds, _X_LEN, _MAX_PERIOD_H + 1)


def yy_lookup_table(w: torch.Tensor) -> torch.Tensor:
    """yy[n, i] = max(0, sum_{j<480} ds[n, 384-i+j]^2), i <= 384, from
    w = forward_window_energies(ds)."""
    return torch.clamp(w.flip(-1), min=0.0)


def pitch_search(ds: torch.Tensor, xc_all: torch.Tensor,
                 w: torch.Tensor | None = None):
    """Coarse->fine pitch search on the whitened half-rate signal.

    Args:
      ds:     [N, 864] output of pitch_downsample.
      xc_all: [N, 385] output of full_xcorr(ds).
      w:      optional [N, 385] forward_window_energies(ds) to share.
    Returns:
      (pitch_index, pitch_corr): [N] int64 period (already flipped to
      768 - pitch as in denoise.cpp:408) and [N] raw correlation value.
    """
    # --- coarse, 4x domain ---
    x4 = ds[..., _X_OFF::2][..., : _X_LEN // 2]        # 240
    lag4 = (C.PITCH_FRAME_SIZE + _MAX_PITCH) >> 2      # 387
    y4 = ds[..., 0 : 2 * lag4 : 2]                     # 387
    xcorr4 = _batched_corr(y4, x4, _COARSE_LAGS)
    b0c, b1c = _find_best_pitch(xcorr4, y4, _X_LEN // 2)

    # --- fine, 2x domain: only lags within +/-2 of 2*coarse candidates ---
    i = torch.arange(_FINE_LAGS, device=ds.device)[None, :]
    near = ((i - 2 * b0c[:, None]).abs() <= 2) | \
        ((i - 2 * b1c[:, None]).abs() <= 2)
    fine_all = xc_all.flip(-1)[..., : _FINE_LAGS]
    xcorr2 = torch.where(near, torch.clamp(fine_all, min=-1.0), 0.0)
    den_fine = None
    if w is not None:
        den_fine = torch.clamp(1.0 + w[..., : _FINE_LAGS], min=1.0)
    b0, _ = _find_best_pitch(xcorr2, ds, _X_LEN, den=den_fine)

    # --- pseudo-interpolation (pitch.cpp:369-384) ---
    interp_idx = torch.stack([torch.clamp(b0 - 1, min=0), b0,
                              torch.clamp(b0 + 1, max=_FINE_LAGS - 1)],
                             dim=-1)
    vals = torch.gather(xcorr2, -1, interp_idx)
    bm1, b, bp1 = vals[..., 0], vals[..., 1], vals[..., 2]
    offset = torch.where(
        (bp1 - bm1) > 0.7 * (b - bm1), 1,
        torch.where((bm1 - bp1) > 0.7 * (b - bp1), -1, 0))
    interior = (b0 > 0) & (b0 < _FINE_LAGS - 1)
    offset = torch.where(interior, offset, 0)

    pitch = 2 * b0 - offset
    return C.PITCH_MAX_PERIOD - pitch, b


# --------------------------------------------------------------------------
# remove_doubling (pitch.cpp:424-527)
# --------------------------------------------------------------------------

def _pitch_gain(xy, xx, yy):
    """compute_pitch_gain (pitch.cpp:417-421): xy / sqrt(1 + xx*yy)."""
    return xy / torch.sqrt(1.0 + xx * yy)


def remove_doubling_precompute(xc_all: torch.Tensor, yy_look: torch.Tensor,
                               t0_in: torch.Tensor) -> dict:
    """Frame-parallel half of remove_doubling.

    Everything in pitch.cpp:424-527 except the prev_period/prev_gain
    hysteresis depends only on the current frame: for each of 15
    candidates (index 0 = keep t0, 1..14 = subharmonic k=2..15) this
    computes the corrected period and gain that would result if that
    candidate were the last one accepted.

    Args: xc_all [N, 385], yy_look [N, 385], t0_in [N] integer.
    Returns: dict of [N], [N, 14] and [N, 15] candidate tensors.
    """
    dev = xc_all.device
    t0 = torch.clamp(t0_in // 2, max=_MAX_PERIOD_H - 1)[..., None]  # [N, 1]
    xx = xc_all[..., 0]

    ks = torch.arange(2, 16, device=dev)
    t1 = (2 * t0 + ks) // (2 * ks)                                  # [N, 14]
    valid = torch.cumsum((t1 < _MIN_PERIOD_H).to(torch.int32), dim=-1) == 0
    sc = C.device_table(_second_check_table, dev)
    t1b_k2 = torch.where(t1 + t0 > _MAX_PERIOD_H, t0, t0 + t1)
    t1b = torch.where(ks == 2, t1b_k2, (2 * sc * t0 + ks) // (2 * ks))
    t1b = torch.clamp(t1b, 0, _MAX_PERIOD_H)

    # final pseudo-interpolation offset (pitch.cpp:510-521) for every lag,
    # read at the candidates below
    c0_all = torch.cat([xc_all[..., :1], xc_all[..., :-1]], dim=-1)
    c2_all = torch.cat([xc_all[..., 1:], xc_all[..., -1:]], dim=-1)
    off_all = torch.where(
        (c2_all - c0_all) > 0.7 * (xc_all - c0_all), 1,
        torch.where((c0_all - c2_all) > 0.7 * (xc_all - c2_all), -1, 0))
    q = torch.arange(_MAX_PERIOD_H + 1, device=dev)
    period_all = torch.clamp(2 * q + off_all, min=C.PITCH_MIN_PERIOD)

    cand_t = torch.cat([t0, t1], dim=-1)                            # [N, 15]
    xc_c = torch.gather(xc_all, -1, cand_t)
    yy_c = torch.gather(yy_look, -1, cand_t)
    cand_period = torch.gather(period_all, -1, cand_t).to(torch.int32)
    xc_t1b = torch.gather(xc_all, -1, t1b)
    yy_t1b = torch.gather(yy_look, -1, t1b)

    xy0, yy0 = xc_c[..., 0], yy_c[..., 0]
    g0 = _pitch_gain(xy0, xx, yy0)
    xy_k = 0.5 * (xc_c[..., 1:] + xc_t1b)
    yy_k = 0.5 * (yy_c[..., 1:] + yy_t1b)
    g1 = _pitch_gain(xy_k, xx[..., None], yy_k)

    # candidate axis: [t0-fallback, k=2..15]
    cand_g = torch.cat([g0[..., None], g1], dim=-1)
    cand_xy = torch.cat([xy0[..., None], xy_k], dim=-1)
    cand_yy = torch.cat([yy0[..., None], yy_k], dim=-1)

    best_xy = torch.clamp(cand_xy, min=0.0)
    pg = torch.where(cand_yy <= best_xy, 1.0, best_xy / (cand_yy + 1.0))
    pg = torch.minimum(pg, cand_g)

    return {"t0": t0[..., 0], "t1": t1, "valid": valid, "g0": g0, "g1": g1,
            "cand_period": cand_period, "cand_gain": pg}


def remove_doubling_select(pre: dict, prev_period: torch.Tensor,
                           prev_gain: torch.Tensor):
    """Hysteresis half: prev-state thresholds + last-accepted-k selection
    (pitch.cpp:485-508), elementwise over the 14 candidates.

    pre: remove_doubling_precompute's dict for one frame of each stream;
    prev_period int32 [N], prev_gain f32 [N].  Returns (period int32 [N],
    gain f32 [N]).
    """
    prev = (prev_period // 2)[..., None]
    t1, g0 = pre["t1"], pre["g0"][..., None]
    ks = torch.arange(2, 16, device=t1.device)
    dt = (t1 - prev).abs()
    pg = prev_gain[..., None]
    # 5*k*k < t0 uses the current frame's t0 (pitch.cpp:490)
    cont = torch.where(
        dt <= 1, pg,
        torch.where((dt <= 2) & (5 * ks * ks < pre["t0"][..., None]),
                    0.5 * pg, 0.0))
    thresh = torch.where(
        t1 < 3 * _MIN_PERIOD_H,
        torch.clamp(0.85 * g0 - cont, min=0.4),
        torch.clamp(0.7 * g0 - cont, min=0.3))
    acc = pre["valid"] & (pre["g1"] > thresh)

    n = acc.shape[-1]
    # index of the LAST accepted candidate (+1), or 0 = keep t0
    last = n - 1 - torch.argmax(acc.flip(-1).to(torch.int32), dim=-1)
    idx = torch.where(acc.any(dim=-1), last + 1, 0)[..., None]
    period = torch.gather(pre["cand_period"], -1, idx)[..., 0]
    gain = torch.gather(pre["cand_gain"], -1, idx)[..., 0]
    return period, gain


def pitch_track_ds(ds: torch.Tensor, init_period: torch.Tensor,
                   init_gain: torch.Tensor) -> dict:
    """Pitch tracking over B streams of T frames.

    Args:
      ds: [B, T, 864] decimated+whitened frames
        (downsample_frames_from_stream).
      init_period: int32 [B], init_gain: f32 [B] hysteresis carry.
    Returns:
      dict with period [B, T] int32, gain [B, T], corr [B, T] f32, and the
      final_period [B] / final_gain [B] carry for the next chunk.
    """
    bsz, t, n = ds.shape
    flat = ds.reshape(bsz * t, n)
    xc = full_xcorr(flat)
    w = forward_window_energies(flat)
    yy = yy_lookup_table(w)
    t0, corr = pitch_search(flat, xc, w)
    pre = remove_doubling_precompute(xc, yy, t0)
    pre = {k: v.reshape(bsz, t, *v.shape[1:]) for k, v in pre.items()}

    period, gain = remove_doubling_scan(pre, init_period, init_gain)
    return {"period": period, "gain": gain, "corr": corr.reshape(bsz, t),
            "final_period": period[:, -1].contiguous(),
            "final_gain": gain[:, -1].contiguous()}


def pitch_track(pitch_bufs: torch.Tensor,
                init_period: torch.Tensor | int | None = None,
                init_gain: torch.Tensor | float | None = None) -> dict:
    """Pitch tracking over one utterance: the JAX package's pitch_track.

    Args:
      pitch_bufs: [T, 1728] per-frame pitch buffers (sliding windows of
        the input signal; see features.frontend).
      init_period, init_gain: scalar hysteresis carry (default 0).
    Returns:
      dict with period [T] int32, gain [T], corr [T] f32, and the scalar
      final_period / final_gain carry for the next chunk.
    """
    dev = pitch_bufs.device
    p0 = torch.as_tensor(0 if init_period is None else init_period,
                         dtype=torch.int32, device=dev).reshape(1)
    g0 = torch.as_tensor(0.0 if init_gain is None else init_gain,
                         dtype=torch.float32, device=dev).reshape(1)
    track = pitch_track_ds(pitch_downsample(pitch_bufs)[None], p0, g0)
    return {k: v[0] for k, v in track.items()}


def remove_doubling_scan(pre: dict, init_period: torch.Tensor,
                         init_gain: torch.Tensor):
    """The hysteresis chain over T frames: remove_doubling_select frame
    by frame from the carry (init_period int32 [B], init_gain f32 [B]),
    batched over streams, every value left on the device.

    pre: remove_doubling_precompute's dict with [B, T, ...] entries.
    Returns (period int32 [B, T], gain f32 [B, T])."""
    p, g = init_period.to(torch.int32), init_gain.to(torch.float32)
    periods, gains = [], []
    for i in range(pre["t0"].shape[1]):
        p, g = remove_doubling_select({k: v[:, i] for k, v in pre.items()},
                                      p, g)
        periods.append(p)
        gains.append(g)
    return torch.stack(periods, 1), torch.stack(gains, 1)
