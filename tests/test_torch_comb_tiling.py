"""The comb kernels' tiling, on the CPU: the span of s_pad a kernel block
stages (tile_span below, the arithmetic of csrc/comb_common.cuh) holds
every tap index the plain version gathers for an in-range frame, fits the
shared memory ops.comb.staged_span sizes, and does not widen for an
out-of-range frame; and the plain version agrees with the JAX package's
_comb_gather on the edge periods those tiles are built for.

The kernels themselves run only on the card (tests/test_torch_gpu.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percepnet_tpu.ops import comb as j_comb
from percepnet_tpu_torch import constants as C
from percepnet_tpu_torch.ops import comb

X_OFFSET = 2400


def _n_pad(t):
    return t * C.FRAME_SIZE + 5280          # the main path's geometry


def tile_span(periods, t0, x_offset, max_p, cols=(0, C.WINDOW_SIZE)):
    """The span [lo, hi] of s_pad a kernel block stages for frames t0,
    t0+1, ... with these periods and columns [c0, c1), as the kernel
    computes it: from the least t*480 + x_offset - 3p + c0 to the largest
    t*480 + x_offset + 3p + c1 - 1 over the frames whose period lies in
    [0, max_p].  None when no frame does (or no column is read)."""
    c0, c1 = cols
    ends = [((t0 + f) * C.FRAME_SIZE + x_offset - C.COMB_M * p + c0,
             (t0 + f) * C.FRAME_SIZE + x_offset + C.COMB_M * p + c1 - 1)
            for f, p in enumerate(int(p) for p in periods)
            if 0 <= p <= max_p and c0 < c1]
    if not ends:
        return None
    return min(lo for lo, _ in ends), max(hi for _, hi in ends)


def _periods(case, bsz, t, seed):
    """[bsz, t] int32 periods of a named case; max_p is 800 here."""
    rng = np.random.default_rng(seed)
    mp = comb.max_period(t, _n_pad(t), X_OFFSET)
    p = rng.integers(60, 770, (bsz, t))
    if case == "p60":
        p[:] = 60
    elif case == "p769":
        p[:] = 769
    elif case == "max_p":
        p[:] = mp
    elif case == "max_p+1":
        p[:, ::3] = mp + 1
    elif case == "mixed":               # one tile: every edge at once
        p[0, :8] = [mp, mp + 1, 60, 769, mp, -1, 60, mp][:t]
    return p.astype(np.int32)


def _tap_indices(t, p, cols):
    """Every s_pad index the plain version gathers for frame t at period
    p over columns [c0, c1): t*480 + x_offset - p*(k-3) + i."""
    i = np.arange(*cols)
    return np.concatenate([t * C.FRAME_SIZE + X_OFFSET - p * (k - 3) + i
                           for k in range(7)])


def _tiles(t, tt, parts, width):
    """(t0, (c0, c1), slice width) of every block of a launch, as the
    kernel cuts it: tiles of tt frames, slices of whole 128-column chunks,
    columns read [c0, c1) and the width shared memory is sized for."""
    chunks = -(-width // comb.CHUNK)
    warps = -(-chunks // parts)
    for t0 in range(0, t, tt):
        for q0 in range(0, chunks, warps):
            c0 = q0 * comb.CHUNK
            c1 = min((q0 + warps) * comb.CHUNK, C.WINDOW_SIZE)
            yield t0, (c0, c1), min(warps * comb.CHUNK, C.WINDOW_SIZE)


CASES = ["random", "p60", "p769", "max_p", "max_p+1", "mixed"]
GRIDS = [(8, 1), (12, 1), (1, 2), (4, 3), (3, 8)]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("t", [1, 13, 37])
def test_staged_span_holds_every_tap_and_fits(case, t):
    """T = 1, a ragged last tile (13 and 37 in tiles of 8, 12 and 4), and
    both row widths: lo >= 0, hi < n_pad, every tap of every in-range
    frame inside [lo, hi], and hi - lo + 1 plus the 3 floats of alignment
    within the staged_span the wrapper sizes shared memory from."""
    bsz, n_pad = 3, _n_pad(t)
    period = _periods(case, bsz, t, seed=t)
    mp = comb.max_period(t, n_pad, X_OFFSET)
    for width in (C.WINDOW_SIZE, comb.ROW_LEN):
        for tt, parts in GRIDS:
            tt = min(tt, t)
            for b in range(bsz):
                for t0, cols, slice_cols in _tiles(t, tt, parts, width):
                    tile = period[b, t0:t0 + tt]
                    span = tile_span(tile, t0, X_OFFSET, mp, cols)
                    in_range = [(t0 + f, int(p)) for f, p in enumerate(tile)
                                if 0 <= p <= mp]
                    if not in_range or cols[0] >= cols[1]:
                        assert span is None
                        continue
                    lo, hi = span
                    assert 0 <= lo and hi < n_pad
                    assert hi - lo + 1 + 3 <= comb.staged_span(tt, mp,
                                                               slice_cols)
                    for tf, p in in_range:
                        idx = _tap_indices(tf, p, cols)
                        assert idx.min() >= lo and idx.max() <= hi


def test_shared_memory_at_main_geometry():
    """max_period is 800 on the main path (n_pad = T*480 + 5280, x_offset
    2400) at every T; a tile of 8 frames stages 9,124 floats, 36,496
    bytes, within 36.5 KB and the 48 KB a block has without opting in."""
    for t in (1, 8, 100, 200):
        assert comb.max_period(t, _n_pad(t), X_OFFSET) == 800
    assert comb.staged_span(8, 800) == 9124
    assert 4 * comb.staged_span(8, 800) <= 36_500 < 48 * 1024
    assert 4 * comb.staged_span(12, 800) <= 48 * 1024
    assert comb.staged_span(1, 800, 512) < comb.staged_span(1, 800)


@pytest.mark.parametrize("bad", [801, 5000, -1])
def test_out_of_range_frame_does_not_widen_the_span(bad):
    mp = 800
    tile = [300, 60, 769, 450]
    assert tile_span(tile + [bad], 5, X_OFFSET, mp) == \
        tile_span(tile, 5, X_OFFSET, mp)
    for at in range(len(tile)):                 # frame `at` out of range
        others = [tile_span([p], 5 + f, X_OFFSET, mp)
                  for f, p in enumerate(tile) if f != at]
        union = (min(lo for lo, _ in others), max(hi for _, hi in others))
        with_bad = tile[:at] + [bad] + tile[at + 1:]
        assert tile_span(with_bad, 5, X_OFFSET, mp) == union
    assert tile_span([bad, bad], 5, X_OFFSET, mp) is None
    assert tile_span(tile, 5, X_OFFSET, mp, (960, 960)) is None


@pytest.mark.parametrize("bsz,t", [(64, 1), (16, 200), (64, 100),
                                   (512, 200), (1, 1), (3, 37)])
def test_tile_grid_fits_the_kernel(bsz, t):
    """Tiles of 1..32 frames and 1..8 slices whose shared memory needs no
    opt-in; the card filled where the shape allows (64 x 1 split in two)."""
    tt, parts = comb.tile_grid(bsz, t)
    assert 1 <= tt <= min(t, 32) and 1 <= parts <= 8
    blocks = bsz * -(-t // tt)
    assert blocks >= comb.RESIDENT_BLOCKS or tt == 1
    assert (parts == 2) == (blocks < comb.SMS)
    cols = min(-(-8 // parts) * comb.CHUNK, C.WINDOW_SIZE)
    assert 4 * comb.staged_span(tt, 800, cols) <= 48 * 1024


def test_wrapper_refuses_a_span_over_shared_memory():
    """An x_offset that allows periods of thousands: the span does not
    fit a block, and the wrapper says so, naming the bytes, before it
    looks at the device."""
    s = torch.zeros((2, 200_000))
    p = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        comb.comb_cuda(s, p, 40_000)
    with pytest.raises(ValueError, match="1..32 frames"):
        comb._launch("windows", C.WINDOW_SIZE, s, p, 2400, torch.float32,
                     (33, 1))


@pytest.mark.parametrize("case", ["p60", "p769", "max_p", "max_p+1",
                                  "mixed"])
@pytest.mark.parametrize("t", [1, 13])
def test_comb_ref_matches_jax_on_edge_periods(case, t):
    """Frames in range: the plain version equals the JAX package's
    _comb_gather to 1e-6 of the output's scale (as test_torch_ops holds
    it on random periods); out of range: NaN frames, the kernels' rule,
    where the JAX function (held only on in-range frames) gets 60."""
    bsz = 3
    rng = np.random.default_rng(7 + t)
    s_pad = rng.standard_normal((bsz, _n_pad(t))).astype(np.float32)
    period = _periods(case, bsz, t, seed=t)
    mp = comb.max_period(t, _n_pad(t), X_OFFSET)
    got = comb.comb_ref(torch.from_numpy(s_pad), torch.from_numpy(period),
                        X_OFFSET).numpy()
    ok = (period >= 0) & (period <= mp)
    assert np.isnan(got[~ok]).all() and np.isfinite(got[ok]).all()
    if not ok.any():                    # T = 1 and every frame past max_p
        return
    clamped = np.where(ok, period, 60).astype(np.int32)
    ref = np.asarray(j_comb._comb_gather(jnp.asarray(s_pad),
                                         jnp.asarray(clamped), X_OFFSET))
    scale = np.abs(ref[ok]).max()
    assert np.abs(got[ok] - ref[ok]).max() / scale <= 1e-6
