"""Plain PyTorch reference of PercepNet enhancement, for the benchmark's
`correct`.

A frozen, self-contained copy of the mathematics of the measured
program's plain tier: analysis (Vorbis window, 960-point real DFT as one
product, 34 ERB bands), the CELT pitch stack (2x decimation, order-4 LPC
whitening, coarse and fine search, remove_doubling with its hysteresis),
the 7-tap pitch comb, the PercepNet network (rnn_train.py:105-145) and the
synthesis (pitch filter, band gains, overlap-add).  Its summation orders
are those of the program's plain tier, on which the pitch decisions
depend.  It imports torch and numpy only: nothing of the program, no
kernel, no cache, and it takes no table, weight or state that the program
made.

It runs a whole sequence of frames at once from a fresh state, where the
program carries state from call to call; chunking does not change the
arithmetic of a frame.

`Precision` names the arithmetic of each part, as a configuration states
it: "float32" (TF32 off), "bfloat16" (operands rounded to bf16; products
and sums in f32, and the model and its recurrence in bf16), and the
control's one step below: "tf32" (operands rounded to TF32's 10-bit
mantissa) and "float8" (operands scaled per tensor into float8 e4m3).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 48_000
FRAME = 480
WINDOW = 960
FREQ = 481
NB_BANDS = 34
LOOKAHEAD = 5
PAD = 5280                       # zeros before a stream: the ring buffers
X_OFF = 2400                     # analysis window of the enhanced frame
PITCH_OFF = 1632                 # pitch buffer
COMB_M = 3
PITCH_MIN = 60
PITCH_MAX = 768
PITCH_T_NORM = PITCH_MAX - 3 * PITCH_MIN      # 588
FEATURE_SCALE = 30.0
DS_LEN = 864
DS_X_OFF = 384
DS_X_LEN = 480
MAX_PITCH = PITCH_MAX - 3 * PITCH_MIN         # 588
COARSE_LAGS = MAX_PITCH >> 2                  # 147
FINE_LAGS = MAX_PITCH >> 1                    # 294
MAX_PERIOD_H = PITCH_MAX // 2                 # 384
MIN_PERIOD_H = PITCH_MIN // 2                 # 30
SECOND_CHECK = (0, 0, 3, 2, 3, 2, 5, 2, 3, 2, 3, 2, 5, 2, 3, 2)
SUM_BLOCK = 32
SCAN_BLOCK = 16
GRU = 512
RB = 128
CONV = 512

# (layer, leaf, shape) of the network's parameters in their flat order
LAYERS = (
    ("fc", "w", (70, 128)), ("fc", "b", (128,)),
    ("conv1", "w", (5, 128, CONV)), ("conv1", "b", (CONV,)),
    ("conv2", "w", (3, CONV, CONV)), ("conv2", "b", (CONV,)),
    *((g, leaf, shape) for g, n_in, n_h in (
        ("gru1", CONV, GRU), ("gru2", GRU, GRU), ("gru3", GRU, GRU),
        ("gru_gb", GRU, GRU), ("gru_rb", 2 * GRU, RB))
      for leaf, shape in (("wi", (n_in, 3 * n_h)), ("wh", (n_h, 3 * n_h)),
                          ("bi", (3 * n_h,)), ("bh", (3 * n_h,)))),
    ("fc_gb", "w", (5 * CONV, NB_BANDS)), ("fc_gb", "b", (NB_BANDS,)),
    ("fc_rb", "w", (RB, NB_BANDS)), ("fc_rb", "b", (NB_BANDS,)),
)


def init_bound(layer: str, shape: tuple[int, ...]) -> float:
    """PyTorch's default uniform init bound 1/sqrt(fan): a GRU's hidden
    size, a conv's in*k, a dense layer's input width."""
    if layer.startswith("gru"):
        return 1.0 / math.sqrt(shape[-1] // 3)
    w = next(s for la, le, s in LAYERS if la == layer and le == "w")
    if layer.startswith("conv"):
        return 1.0 / math.sqrt(w[0] * w[1])
    return 1.0 / math.sqrt(w[0])


def unflatten(flat: torch.Tensor) -> dict[str, dict[str, torch.Tensor]]:
    """The network's leaves as views of one flat f32 vector, in LAYERS'
    order."""
    out: dict[str, dict[str, torch.Tensor]] = {}
    pos = 0
    for layer, leaf, shape in LAYERS:
        n = math.prod(shape)
        out.setdefault(layer, {})[leaf] = flat[pos : pos + n].view(shape)
        pos += n
    if pos != flat.numel():
        raise ValueError(f"{flat.numel()} weights, the network has {pos}")
    return out


# --------------------------------------------------------------------------
# arithmetic of each part
# --------------------------------------------------------------------------

def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10 mantissa bits (nearest, ties away
    from zero), as a tensor core takes its operands."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """Values scaled per tensor so that the largest is 448, rounded to
    float8 e4m3 and scaled back, in x's dtype."""
    amax = x.detach().abs().max().to(torch.float32).clamp(min=1e-30)
    scale = 448.0 / amax
    q = (x.to(torch.float32) * scale).to(torch.float8_e4m3fn)
    return (q.to(torch.float32) / scale).to(x.dtype)


@dataclass(frozen=True)
class Precision:
    """The arithmetic of each part: dft (analysis, comb and synthesis
    transforms), comb_store, model, pitch (correlations), bands (the ERB
    products)."""
    dft: str = "float32"
    comb_store: str = "float32"
    model: str = "float32"
    pitch: str = "float32"
    bands: str = "float32"

    @classmethod
    def from_config(cls, cfg: dict) -> "Precision":
        return cls(**cfg["precision"])

    def lower(self) -> "Precision":
        """The control: each part one step below (f32 -> TF32, bf16 ->
        float8)."""
        step = {"float32": "tf32", "bfloat16": "float8"}
        return Precision(**{k: step[v] for k, v in vars(self).items()})


def operand(x: torch.Tensor, kind: str) -> torch.Tensor:
    """A product's operand in f32 as the part's arithmetic takes it."""
    x = x.to(torch.float32)
    if kind == "float32":
        return x
    if kind == "tf32":
        return round_tf32(x)
    if kind == "bfloat16":
        return x.to(torch.bfloat16).to(torch.float32)
    if kind == "float8":
        return round_fp8(x)
    raise ValueError(f"unknown arithmetic {kind!r}")


def product(a: torch.Tensor, b: torch.Tensor, kind: str) -> torch.Tensor:
    """a @ b in f32 from operands in the part's arithmetic."""
    return torch.matmul(operand(a, kind), operand(b, kind))


# --------------------------------------------------------------------------
# tables (built in float64 from their formulas, cast once to f32)
# --------------------------------------------------------------------------

def _erb_borders() -> np.ndarray:
    f32 = np.float32
    n = NB_BANDS - 2
    freq2erb = lambda f: f32(9.265) * np.log1p(                   # noqa: E731
        np.asarray(f, f32) / f32(24.7 * 9.265))
    lo, hi = freq2erb(0.0), freq2erb(20_000.0)
    delta = (hi - lo) / f32(n + 1)
    lims = lo + delta * np.arange(n + 1, dtype=f32)
    lims = np.concatenate([lims, [hi]]).astype(f32)
    cutoffs = f32(24.7 * 9.265) * (np.exp(lims / f32(9.265)) - f32(1))
    borders = ((cutoffs + f32(25.0)) / f32(50.0)).astype(np.int32).copy()
    for k in range(n):
        if borders[k + 1] - borders[k] < 2:
            borders[k + 1] += 2 - (borders[k + 1] - borders[k])
    return borders


def _band_matrices() -> tuple[np.ndarray, np.ndarray]:
    """([481, 34] energy split, [34, 481] interpolation)."""
    borders = _erb_borders()
    energy = np.zeros((NB_BANDS, FREQ), np.float32)
    interp = np.zeros((FREQ, NB_BANDS), np.float32)
    for i in range(NB_BANDS - 1):
        size = int(borders[i + 1] - borders[i])
        for j in range(size):
            frac = np.float32(j) / np.float32(size)
            energy[i, borders[i] + j] += 1 - frac
            energy[i + 1, borders[i] + j] += frac
            interp[borders[i] + j, i] = 1 - frac
            interp[borders[i] + j, i + 1] = frac
    energy[0] *= 2
    energy[-1] *= 2
    return energy.T.copy(), interp.T.copy()


def _window() -> np.ndarray:
    i = np.arange(FRAME, dtype=np.float64)
    s = np.sin(0.5 * math.pi * (i + 0.5) / FRAME)
    h = np.sin(0.5 * math.pi * s * s).astype(np.float32)
    return np.concatenate([h, h[::-1]]).astype(np.float32)


def _comb_taps() -> np.ndarray:
    i = np.arange(1, 2 * COMB_M + 2, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * math.pi * i / (2 * COMB_M + 2))
    return (w / w.sum()).astype(np.float32)


def _dft_tables() -> tuple[np.ndarray, np.ndarray]:
    """([960, 962] forward [cos | -sin] / n, [962, 960] inverse)."""
    k = np.arange(FREQ, dtype=np.float64)
    t = np.arange(WINDOW, dtype=np.float64)
    ang = 2.0 * math.pi * k[:, None] * t[None, :] / WINDOW
    c = (np.cos(ang) / WINDOW).astype(np.float32)
    s = (np.sin(ang) / WINDOW).astype(np.float32)
    fwd = np.concatenate([c, -s], axis=0).T.copy()
    w = np.full((FREQ, 1), 2.0)
    w[0] = w[-1] = 1.0
    ci = (w * np.cos(ang)).astype(np.float32)
    si = (w * np.sin(ang)).astype(np.float32)
    inv = np.concatenate([ci, -si], axis=0).copy()
    return fwd, inv


class Tables:
    """Every table on one device."""

    def __init__(self, device: torch.device):
        t = lambda a: torch.from_numpy(a).to(device)               # noqa: E731
        fwd, inv = _dft_tables()
        energy, interp = _band_matrices()
        self.fwd, self.inv = t(fwd), t(inv)
        self.energy, self.interp = t(energy), t(interp)
        self.window, self.taps = t(_window()), t(_comb_taps())
        self.second_check = t(np.asarray(SECOND_CHECK[2:], np.int64))


# --------------------------------------------------------------------------
# analysis
# --------------------------------------------------------------------------

def forward_dft(x, tb: Tables, kind: str):
    xcs = product(x, tb.fwd, kind)
    return xcs[..., :FREQ], xcs[..., FREQ:]


def band_energy(xr, xi, tb: Tables, kind: str):
    return product(xr * xr + xi * xi, tb.energy, kind)


def comb_windows(s_pad: torch.Tensor, period: torch.Tensor, tb: Tables,
                 store: str) -> torch.Tensor:
    """[B, T, 960] windowed 7-tap comb, taps accumulated k = 0..6, window
    last, then stored in the part's type (bf16: rounded once)."""
    bsz, t = period.shape
    dev = s_pad.device
    base = (torch.arange(t, device=dev) * FRAME + X_OFF)[:, None] \
        + torch.arange(WINDOW, device=dev)[None, :]
    p = period.to(torch.int64)[..., None]
    acc = torch.zeros((bsz, t, WINDOW), dtype=torch.float32, device=dev)
    for kk in range(2 * COMB_M + 1):
        idx = base - p * (kk - COMB_M)
        tap = torch.gather(s_pad, 1, idx.reshape(bsz, -1)).reshape(idx.shape)
        acc = acc + tb.taps[kk] * tap
    out = acc * tb.window
    if store in ("bfloat16", "float8"):
        out = operand(out, store)
    return out


# --- pitch ------------------------------------------------------------------

def _seq_sum(x):
    acc = x[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def _block_pad(n: int) -> tuple[int, int]:
    pad = -(-n // SUM_BLOCK) * SUM_BLOCK - n
    return pad // 2, pad - pad // 2


def _tree_sum(x):
    n = x.shape[-1]
    if n <= SUM_BLOCK:
        return _seq_sum(x)
    xp = F.pad(x, _block_pad(n))
    return _tree_sum(_seq_sum(xp.reshape(*x.shape[:-1], -1, SUM_BLOCK)))


def _levinson4(ac):
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


def _whiten(ds):
    n = ds.shape[-1]
    prods = [ds * ds] + [ds[..., k:] * ds[..., : n - k] for k in range(1, 5)]
    ac = _tree_sum(torch.stack(
        [F.pad(p, _block_pad(p.shape[-1])) for p in prods], dim=-2))
    steps = torch.arange(1, 5, dtype=torch.float32, device=ds.device)
    ac = torch.cat([ac[..., :1] * 1.0001,
                    ac[..., 1:] * (1.0 - (0.008 * steps) ** 2)], dim=-1)
    lpc = _levinson4(ac) * (0.9 ** steps)
    c1 = 0.8
    num = torch.stack([lpc[..., 0] + c1, lpc[..., 1] + c1 * lpc[..., 0],
                       lpc[..., 2] + c1 * lpc[..., 1],
                       lpc[..., 3] + c1 * lpc[..., 2], c1 * lpc[..., 3]],
                      dim=-1)
    dsp = F.pad(ds, (5, 0))
    y = ds
    for m in range(5):
        y = y + num[..., m : m + 1] * dsp[..., 4 - m : 4 - m + n]
    return y


def _decimate(x):
    even, odd = x[..., 0::2], x[..., 1::2]
    prev = torch.cat([torch.zeros_like(odd[..., :1]), odd[..., :-1]], dim=-1)
    return 0.25 * (prev + odd) + 0.5 * even


def pitch_frames(s_pad: torch.Tensor, n_frames: int) -> torch.Tensor:
    """[B, T, 864] decimated and whitened pitch frames; column 0 of each
    is the buffer-start value, as a fresh pitch buffer gives it."""
    ds = _decimate(s_pad)
    end = PITCH_OFF + (n_frames - 1) * FRAME + 2
    col0 = 0.25 * s_pad[..., PITCH_OFF + 1:end:FRAME] \
        + 0.5 * s_pad[..., PITCH_OFF:end:FRAME]
    need = PITCH_OFF // 2 + (n_frames - 1) * (FRAME // 2) + DS_LEN
    if ds.shape[-1] < need:
        ds = F.pad(ds, (0, need - ds.shape[-1]))
    dsf = ds[..., PITCH_OFF // 2 : need].unfold(-1, DS_LEN, FRAME // 2)
    return _whiten(torch.cat([col0[..., None], dsf[..., 1:]], dim=-1))


def _corr(sig, ker, out_len, kind):
    n = sig.shape[0]
    out = F.conv1d(operand(sig, kind)[None], operand(ker, kind)[:, None, :],
                   groups=n)
    return out[0, :, :out_len]


def _seq_prefix(x):
    cols = [x[..., 0]]
    for j in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., j])
    return torch.stack(cols, dim=-1)


def _prefix_sum(x):
    n = x.shape[-1]
    if n <= SCAN_BLOCK:
        return _seq_prefix(x)
    m = -(-n // SCAN_BLOCK)
    inner = _seq_prefix(F.pad(x, (0, m * SCAN_BLOCK - n)).reshape(
        *x.shape[:-1], m, SCAN_BLOCK))
    totals = _prefix_sum(inner[..., -1])
    before = torch.cat([torch.zeros_like(totals[..., :1]), totals[..., :-1]],
                       dim=-1)
    return (inner + before[..., None]).reshape(
        *x.shape[:-1], m * SCAN_BLOCK)[..., :n]


def _window_energy(y, length, n_out):
    c = _prefix_sum(y * y)
    c = torch.cat([torch.zeros_like(c[..., :1]), c], dim=-1)
    return c[..., length : length + n_out] - c[..., :n_out]


def _best_pitch(xcorr, den):
    m = xcorr.shape[-1]
    considered = xcorr > 0
    score = torch.where(considered, torch.square(xcorr * 1e-12) / den, -1.0)
    cnt = considered.sum(dim=-1)
    i0 = torch.argmax(score, dim=-1)
    iota = torch.arange(m, device=xcorr.device)
    i1 = torch.argmax(torch.where(iota[None] == i0[:, None], -2.0, score),
                      dim=-1)
    return (torch.where(cnt > 0, i0, 0),
            torch.where(cnt >= 2, i1, torch.where(cnt == 1, 0, 1)))


def _pitch_search(ds, xc_all, w, kind):
    x4 = ds[..., DS_X_OFF::2][..., : DS_X_LEN // 2]
    lag4 = (WINDOW + MAX_PITCH) >> 2
    y4 = ds[..., 0 : 2 * lag4 : 2]
    xcorr4 = _corr(y4, x4, COARSE_LAGS, kind)
    den4 = torch.clamp(1.0 + _window_energy(y4, DS_X_LEN // 2, COARSE_LAGS),
                       min=1.0)
    b0c, b1c = _best_pitch(xcorr4, den4)
    i = torch.arange(FINE_LAGS, device=ds.device)[None]
    near = ((i - 2 * b0c[:, None]).abs() <= 2) | \
        ((i - 2 * b1c[:, None]).abs() <= 2)
    fine = xc_all.flip(-1)[..., :FINE_LAGS]
    xcorr2 = torch.where(near, torch.clamp(fine, min=-1.0), 0.0)
    b0, _ = _best_pitch(xcorr2, torch.clamp(1.0 + w[..., :FINE_LAGS],
                                            min=1.0))
    idx = torch.stack([torch.clamp(b0 - 1, min=0), b0,
                       torch.clamp(b0 + 1, max=FINE_LAGS - 1)], dim=-1)
    vals = torch.gather(xcorr2, -1, idx)
    bm1, b, bp1 = vals[..., 0], vals[..., 1], vals[..., 2]
    off = torch.where((bp1 - bm1) > 0.7 * (b - bm1), 1,
                      torch.where((bm1 - bp1) > 0.7 * (b - bp1), -1, 0))
    off = torch.where((b0 > 0) & (b0 < FINE_LAGS - 1), off, 0)
    return PITCH_MAX - (2 * b0 - off), b


def _gain(xy, xx, yy):
    return xy / torch.sqrt(1.0 + xx * yy)


def _doubling_candidates(xc_all, yy_look, t0_in, tb: Tables):
    dev = xc_all.device
    t0 = torch.clamp(t0_in // 2, max=MAX_PERIOD_H - 1)[..., None]
    xx = xc_all[..., 0]
    ks = torch.arange(2, 16, device=dev)
    t1 = (2 * t0 + ks) // (2 * ks)
    valid = torch.cumsum((t1 < MIN_PERIOD_H).to(torch.int32), dim=-1) == 0
    t1b = torch.where(ks == 2,
                      torch.where(t1 + t0 > MAX_PERIOD_H, t0, t0 + t1),
                      (2 * tb.second_check * t0 + ks) // (2 * ks))
    t1b = torch.clamp(t1b, 0, MAX_PERIOD_H)
    c0 = torch.cat([xc_all[..., :1], xc_all[..., :-1]], dim=-1)
    c2 = torch.cat([xc_all[..., 1:], xc_all[..., -1:]], dim=-1)
    off = torch.where((c2 - c0) > 0.7 * (xc_all - c0), 1,
                      torch.where((c0 - c2) > 0.7 * (xc_all - c2), -1, 0))
    q = torch.arange(MAX_PERIOD_H + 1, device=dev)
    period_all = torch.clamp(2 * q + off, min=PITCH_MIN)
    cand = torch.cat([t0, t1], dim=-1)
    xc_c = torch.gather(xc_all, -1, cand)
    yy_c = torch.gather(yy_look, -1, cand)
    xy0, yy0 = xc_c[..., 0], yy_c[..., 0]
    g0 = _gain(xy0, xx, yy0)
    xy_k = 0.5 * (xc_c[..., 1:] + torch.gather(xc_all, -1, t1b))
    yy_k = 0.5 * (yy_c[..., 1:] + torch.gather(yy_look, -1, t1b))
    g1 = _gain(xy_k, xx[..., None], yy_k)
    best = torch.clamp(torch.cat([xy0[..., None], xy_k], dim=-1), min=0.0)
    cyy = torch.cat([yy0[..., None], yy_k], dim=-1)
    pg = torch.where(cyy <= best, 1.0, best / (cyy + 1.0))
    pg = torch.minimum(pg, torch.cat([g0[..., None], g1], dim=-1))
    return {"t0": t0[..., 0], "t1": t1, "valid": valid, "g0": g0, "g1": g1,
            "cand_period": torch.gather(period_all, -1, cand).to(torch.int32),
            "cand_gain": pg}


def _hysteresis(pre: dict, prev_period, prev_gain):
    prev = (prev_period // 2)[..., None]
    t1, g0 = pre["t1"], pre["g0"][..., None]
    ks = torch.arange(2, 16, device=t1.device)
    dt = (t1 - prev).abs()
    pg = prev_gain[..., None]
    cont = torch.where(dt <= 1, pg, torch.where(
        (dt <= 2) & (5 * ks * ks < pre["t0"][..., None]), 0.5 * pg, 0.0))
    thresh = torch.where(t1 < 3 * MIN_PERIOD_H,
                         torch.clamp(0.85 * g0 - cont, min=0.4),
                         torch.clamp(0.7 * g0 - cont, min=0.3))
    acc = pre["valid"] & (pre["g1"] > thresh)
    n = acc.shape[-1]
    last = n - 1 - torch.argmax(acc.flip(-1).to(torch.int32), dim=-1)
    idx = torch.where(acc.any(dim=-1), last + 1, 0)[..., None]
    return (torch.gather(pre["cand_period"], -1, idx)[..., 0],
            torch.gather(pre["cand_gain"], -1, idx)[..., 0])


def pitch_track(ds: torch.Tensor, tb: Tables, kind: str):
    """[B, T, 864] -> (period int32 [B, T], corr [B, T]) from a fresh
    hysteresis state."""
    bsz, t, n = ds.shape
    flat = ds.reshape(bsz * t, n)
    xc = _corr(flat, flat[..., DS_X_OFF:], MAX_PERIOD_H + 1, kind).flip(-1)
    w = _window_energy(flat, DS_X_LEN, MAX_PERIOD_H + 1)
    t0, corr = _pitch_search(flat, xc, w, kind)
    pre = _doubling_candidates(xc, torch.clamp(w.flip(-1), min=0.0), t0, tb)
    pre = {k: v.reshape(bsz, t, *v.shape[1:]) for k, v in pre.items()}
    p = torch.zeros(bsz, dtype=torch.int32, device=ds.device)
    g = torch.zeros(bsz, dtype=torch.float32, device=ds.device)
    periods = []
    for i in range(t):
        p, g = _hysteresis({k: v[:, i] for k, v in pre.items()}, p, g)
        periods.append(p)
    return torch.stack(periods, 1), corr.reshape(bsz, t)


def analyze(signal: torch.Tensor, tb: Tables, prec: Precision) -> dict:
    """[B, n] f32 PCM (/32768 scale), fresh state -> per-frame dict:
    xr, xi, pr, pi [B, T, 481], ex, ep, exp [B, T, 34], period, silence
    [B, T], features [B, T, 70]."""
    bsz, n = signal.shape
    t = n // FRAME
    s_pad = torch.cat([signal.new_zeros(bsz, PAD), signal], dim=-1)
    frames = s_pad[:, X_OFF:].unfold(-1, WINDOW, FRAME) * tb.window
    xr_e, xi_e = forward_dft(frames, tb, prec.dft)
    ex_e = band_energy(xr_e, xi_e, tb, prec.bands)
    xr, xi, ex = xr_e[:, :t], xi_e[:, :t], ex_e[:, :t]
    period, corr = pitch_track(pitch_frames(s_pad, t), tb, prec.pitch)
    pw = comb_windows(s_pad, period, tb, prec.comb_store)
    pr, pi = forward_dft(pw, tb, prec.dft)
    ep = band_energy(pr, pi, tb, prec.bands)
    corr_b = product(xr * pr + xi * pi, tb.energy, prec.bands)
    exp = torch.clamp(corr_b / torch.sqrt(1e-15 + ex * ep), 0.0, 1.0)
    features = torch.cat([ex_e[:, LOOKAHEAD:] * FEATURE_SCALE,
                          exp * FEATURE_SCALE,
                          (period.to(torch.float32) / PITCH_T_NORM)[..., None],
                          corr[..., None]], dim=-1)
    return dict(xr=xr, xi=xi, pr=pr, pi=pi, ex=ex, ep=ep, exp=exp,
                period=period, silence=torch.sum(ex, dim=-1) < 0.1,
                features=features)


# --------------------------------------------------------------------------
# the network
# --------------------------------------------------------------------------

def _mm(x, w, kind):
    """x @ w: f32 parts as products of f32 operands (TF32-rounded for the
    control); bf16 parts as bf16 tensors (float8-rounded operands for the
    control), the result in bf16."""
    if kind in ("float32", "tf32"):
        return product(x, w, kind)
    if kind == "float8":
        return torch.matmul(round_fp8(x), round_fp8(w))
    return torch.matmul(x, w)


def _gru(p, h, xp, kind):
    gh = _mm(h, p["wh"], kind) + p["bh"]
    xr, xz, xn = xp.chunk(3, dim=-1)
    hr, hz, hn = gh.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    cand = torch.tanh(xn + r * hn)
    return (1.0 - z) * cand + z * h


def network(features: torch.Tensor, weights: dict, kind: str,
            log1p: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, T, 70] features -> (g, r) [B, T, 34] f32 from a zero state.
    kind "bfloat16" / "float8" runs parameters, features and the
    recurrence in bf16, the heads' sigmoids in f32."""
    dtype = torch.bfloat16 if kind in ("bfloat16", "float8") else \
        torch.float32
    if log1p:
        features = torch.cat([torch.log1p(features[..., :68]),
                              features[..., 68:]], dim=-1)
    p = {la: {le: v.to(dtype) for le, v in leaves.items()}
         for la, leaves in weights.items()}
    bsz, t, _ = features.shape
    x = torch.relu(_mm(features.to(dtype), p["fc"]["w"], kind)
                   + p["fc"]["b"])

    def conv(q, x, act):
        k = q["w"].shape[0]
        xp = torch.cat([x.new_zeros(bsz, k - 1, x.shape[-1]), x], dim=1)
        out = q["b"]
        for i in range(k):
            out = out + _mm(xp[:, i : i + t], q["w"][i], kind)
        return act(out)

    conv_out = conv(p["conv2"], conv(p["conv1"], x, torch.relu), torch.tanh)
    pre1 = _mm(conv_out, p["gru1"]["wi"], kind) + p["gru1"]["bi"]
    wi_rb = p["gru_rb"]["wi"]
    pre_rb = _mm(conv_out, wi_rb[GRU:], kind) + p["gru_rb"]["bi"]
    z = lambda n: features.new_zeros(bsz, n, dtype=dtype)          # noqa: E731
    h1, h2, h3, hgb, hrb = z(GRU), z(GRU), z(GRU), z(GRU), z(RB)
    seqs = ([], [], [], [], [])
    for i in range(t):
        h1 = _gru(p["gru1"], h1, pre1[:, i], kind)
        h2 = _gru(p["gru2"], h2, _mm(h1, p["gru2"]["wi"], kind)
                  + p["gru2"]["bi"], kind)
        h3 = _gru(p["gru3"], h3, _mm(h2, p["gru3"]["wi"], kind)
                  + p["gru3"]["bi"], kind)
        hgb = _gru(p["gru_gb"], hgb, _mm(h3, p["gru_gb"]["wi"], kind)
                   + p["gru_gb"]["bi"], kind)
        hrb = _gru(p["gru_rb"], hrb, pre_rb[:, i]
                   + _mm(h3, wi_rb[:GRU], kind), kind)
        for seq, h in zip(seqs, (h1, h2, h3, hgb, hrb)):
            seq.append(h)
    h1s, h2s, h3s, hgbs, hrbs = (torch.stack(s, dim=1) for s in seqs)
    w_gb = p["fc_gb"]["w"]
    gb = (_mm(conv_out, w_gb[:CONV], kind)
          + _mm(h1s, w_gb[CONV : 2 * CONV], kind)
          + _mm(h2s, w_gb[2 * CONV : 3 * CONV], kind)
          + _mm(h3s, w_gb[3 * CONV : 4 * CONV], kind)
          + _mm(hgbs, w_gb[4 * CONV:], kind) + p["fc_gb"]["b"])
    rb = _mm(hrbs, p["fc_rb"]["w"], kind) + p["fc_rb"]["b"]
    return (torch.sigmoid(gb.to(torch.float32)),
            torch.sigmoid(rb.to(torch.float32)))


# --------------------------------------------------------------------------
# synthesis
# --------------------------------------------------------------------------

def synthesize(front: dict, g, r, tb: Tables, prec: Precision):
    """Pitch filter, band gains and overlap-add: [B, T*480] f32 PCM."""
    rf = product(r, tb.interp, prec.bands)
    inv_rf = product(1.0 - r, tb.interp, prec.bands)
    sil = front["silence"][..., None]
    xr = torch.where(sil, front["xr"], inv_rf * front["xr"] + rf * front["pr"])
    xi = torch.where(sil, front["xi"], inv_rf * front["xi"] + rf * front["pi"])
    gf = product(g, tb.interp, prec.bands)
    xr, xi = xr * gf, xi * gf
    x = product(torch.cat([xr, xi], dim=-1), tb.inv, prec.dft) * tb.window
    first, second = x[..., :FRAME], x[..., FRAME:]
    prev = torch.cat([torch.zeros_like(second[:, :1]), second[:, :-1]], dim=1)
    out = first + prev
    return out.reshape(out.shape[0], -1)


def to_int16(pcm: torch.Tensor) -> torch.Tensor:
    """The int16 wire's output: x 32768, clipped, truncated toward zero."""
    return torch.clamp(pcm * 32768.0, -32768.0, 32767.0).to(torch.int16)


@torch.no_grad()
def enhance(signal: torch.Tensor, weights: dict, prec: Precision,
            log1p: bool, tb: Tables | None = None) -> dict:
    """Enhance [B, n] f32 PCM (/32768) from a fresh state.  Returns the
    per-frame quantities the benchmark compares: period [B, T] int32,
    features [B, T, 70], ep [B, T, 34], g, r [B, T, 34] and pcm
    [B, T*480].  TF32 is switched off: "float32" means float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    tb = tb or Tables(signal.device)
    front = analyze(signal.to(torch.float32), tb, prec)
    g, r = network(front["features"], weights, prec.model, log1p)
    pcm = synthesize(front, g, r, tb, prec)
    return {"period": front["period"], "features": front["features"],
            "ep": front["ep"], "g": g, "r": r, "pcm": pcm}
