"""The benchmark's one traffic generator.  A mix is a JSON file of
parameters under benchmark/traffic/; its "kind" names the loop that
drives it, benchmark/loops/<kind>.py ("batch": back-to-back
enhance_chunk calls; "stream": the server's ticks), and everything else
is read here.

Every input is made from the run's seed: a pool of speech-like and noise
clips (harness.synth), then for each stream or session a speech clip, a
noise clip, two start offsets and an SNR.  A stream plays its clips
circularly from its offsets; the mixture is put on the int16 grid
(rounded, clipped), as PCM from a file or a wire is.  The same seed gives
the same inputs; every seed gives the same sizes and the same number of
calls, slots and frames.
"""

from __future__ import annotations

import json
import math
import pathlib
from dataclasses import dataclass

import numpy as np
import torch

from benchmark.harness import synth

FRAME = 480
SAMPLE_RATE = 48_000


def load_mix(root: pathlib.Path, name: str) -> dict:
    """benchmark/traffic/<name>.json."""
    path = root / "traffic" / f"{name}.json"
    with open(path) as f:
        mix = json.load(f)
    if not isinstance(mix.get("kind"), str):
        raise ValueError(f"{path}: a mix names its loop under 'kind'")
    return mix


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A numpy Generator for one purpose of one seed (any non-negative
    integer, however large)."""
    return np.random.default_rng(np.random.SeedSequence([seed, *stream]))


def torch_seed(seed: int, *stream: int) -> int:
    """A 63-bit torch seed for one purpose of one seed."""
    return int(np.random.SeedSequence([seed, *stream]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


# purposes of a seed's generators
POOL, STREAMS, SESSIONS, SAMPLE, WEIGHTS, BURSTS = range(6)


@dataclass
class Pool:
    """Speech clips peak-normalised to 1 and noise clips of unit standard
    deviation, each `length` samples, float32."""
    speech: np.ndarray           # [n_speech, length]
    noise: np.ndarray            # [n_noise, length]
    speech_power: np.ndarray     # [n_speech] mean square
    noise_peak: np.ndarray       # [n_noise] largest |sample|

    @property
    def length(self) -> int:
        return self.speech.shape[1]


def make_pool(mix: dict, seed: int) -> Pool:
    p = mix["pool"]
    rng = rng_for(seed, POOL)
    speech = np.stack([synth.synth_speech(p["clip_seconds"], rng)
                       for _ in range(p["speech_clips"])]).astype(np.float32)
    noise = np.stack([synth.synth_noise(p["clip_seconds"], rng)
                      for _ in range(p["noise_clips"])]).astype(np.float32)
    return Pool(speech, noise, np.mean(speech.astype(np.float64) ** 2, 1),
                np.abs(noise).max(1))


@dataclass
class Voices:
    """Per stream or session: clips, start offsets and mixing gains."""
    speech_clip: np.ndarray      # int64 [N]
    noise_clip: np.ndarray
    speech_off: np.ndarray       # int64 [N], samples
    noise_off: np.ndarray
    speech_gain: np.ndarray      # float64 [N]
    noise_gain: np.ndarray


def draw_voices(mix: dict, pool: Pool, n: int,
                rng: np.random.Generator) -> Voices:
    """n voices: clips and offsets uniform, SNR uniform over mix
    ["snr_db"]; the gains put the sum's largest possible value at
    mix["peak"] on the int16 scale."""
    sc = rng.integers(0, pool.speech.shape[0], n)
    nc = rng.integers(0, pool.noise.shape[0], n)
    so = rng.integers(0, pool.length, n)
    no = rng.integers(0, pool.length, n)
    snr = rng.uniform(*mix["snr_db"], n)
    noise_rel = np.sqrt(pool.speech_power[sc] * 10.0 ** (-snr / 10.0))
    scale = mix["peak"] / (1.0 + noise_rel * pool.noise_peak[nc])
    return Voices(sc, nc, so, no, scale, scale * noise_rel)


def to_grid(x: torch.Tensor) -> torch.Tensor:
    """Round to the int16 grid and clip, in float32."""
    return torch.clamp(torch.round(x), -32768.0, 32767.0)


class BatchFeed:
    """The batch mix: mix["streams"] long streams, each a clip pair played
    from its offsets, fed mix["frames_per_call"] frames at a time.  The
    pool lives on the device; call k's chunk is gathered there."""

    def __init__(self, mix: dict, seed: int, device: torch.device):
        self.streams = mix["streams"]
        self.n = mix["frames_per_call"] * FRAME
        pool = make_pool(mix, seed)
        v = draw_voices(mix, pool, self.streams, rng_for(seed, STREAMS))
        self.length = pool.length
        if self.n > self.length:
            raise ValueError("a call's chunk is longer than a clip")
        dev = device
        # each clip twice over, so that any chunk is one contiguous read
        self.speech = torch.from_numpy(np.tile(pool.speech, 2)).to(dev)
        self.noise = torch.from_numpy(np.tile(pool.noise, 2)).to(dev)
        t = lambda a, d: torch.as_tensor(a, dtype=d, device=dev)  # noqa: E731
        self.sc, self.nc = t(v.speech_clip, torch.int64), t(v.noise_clip,
                                                            torch.int64)
        self.so, self.no = t(v.speech_off, torch.int64), t(v.noise_off,
                                                           torch.int64)
        self.sg = t(v.speech_gain, torch.float32)[:, None]
        self.ng = t(v.noise_gain, torch.float32)[:, None]
        self.iota = torch.arange(self.n, device=dev)

    def chunk(self, k: int, rows: torch.Tensor | None = None
              ) -> torch.Tensor:
        """Call k's [streams, n] float32 PCM at /32768 scale (or of the
        given rows only), on the device."""
        sl = slice(None) if rows is None else rows
        two = 2 * self.length
        s0 = (self.so[sl] + k * self.n) % self.length
        n0 = (self.no[sl] + k * self.n) % self.length
        s = torch.take(self.speech, (self.sc[sl] * two + s0)[:, None]
                       + self.iota)
        z = torch.take(self.noise, (self.nc[sl] * two + n0)[:, None]
                       + self.iota)
        return to_grid(self.sg[sl] * s + self.ng[sl] * z) * (1.0 / 32768.0)

    def signal(self, rows: torch.Tensor, calls: int) -> torch.Tensor:
        """The given rows' whole signal over `calls` calls, [rows, calls*n]:
        what the reference is given."""
        return torch.cat([self.chunk(k, rows) for k in range(calls)], dim=1)


@dataclass
class Session:
    slot: int
    start: int                   # first tick
    frames: int                  # length in frames (ticks)
    voice: int                   # index into the schedule's voices


class StreamSchedule:
    """The stream mix: `slots` slots, every one occupied all the time by
    back-to-back sessions whose lengths are log-uniform over
    mix["session_seconds"]; a session that ends leaves its slot to the
    next one in the same tick.  An optional mix["burst"], {"every_s": P,
    "share": f}, ends the sessions of round(f * slots) slots, drawn from
    the seed, every P seconds, so that as many new ones attach in that
    tick.  `audio` holds every slot's input for `ticks` ticks on the
    host, int16 or float32 at /32768 scale, rendered on `device`."""

    def __init__(self, mix: dict, seed: int, slots: int, ticks: int,
                 int16: bool, device: torch.device):
        self.slots, self.ticks = slots, ticks
        self.pool = make_pool(mix, seed)
        rng = rng_for(seed, SESSIONS)
        lo, hi = (math.log(s * SAMPLE_RATE / FRAME)
                  for s in mix["session_seconds"])
        cuts = self._cuts(mix.get("burst"), seed, slots, ticks)
        self.sessions: list[Session] = []
        for slot in range(slots):
            t = 0
            mine = cuts.get(slot, [])
            while t < ticks:
                frames = int(round(math.exp(rng.uniform(lo, hi))))
                cut = next((c for c in mine if c > t), None)
                if cut is not None and t + frames > cut:
                    frames = cut - t
                self.sessions.append(Session(slot, t, frames,
                                             len(self.sessions)))
                t += frames
        self.voices = draw_voices(mix, self.pool, len(self.sessions),
                                  rng_for(seed, STREAMS))
        self.int16 = int16
        self.audio = self._render(device)

    @staticmethod
    def _cuts(burst: dict | None, seed: int, slots: int, ticks: int
              ) -> dict[int, list[int]]:
        """{slot: the ticks at which a burst ends its session}."""
        if not burst:
            return {}
        every = max(1, round(burst["every_s"] * SAMPLE_RATE / FRAME))
        n = min(slots, round(burst["share"] * slots))
        rng = rng_for(seed, BURSTS)
        cuts: dict[int, list[int]] = {}
        for k in range(every, ticks, every):
            for slot in rng.choice(slots, size=n, replace=False):
                cuts.setdefault(int(slot), []).append(k)
        return cuts

    def _render(self, device: torch.device, block: int = 200
                ) -> np.ndarray:
        """[slots, ticks*480] every slot's input in the wire's type."""
        voice = np.zeros((self.slots, self.ticks), np.int64)
        frame = np.zeros((self.slots, self.ticks), np.int64)
        for s in self.sessions:
            n = min(s.frames, self.ticks - s.start)
            voice[s.slot, s.start : s.start + n] = s.voice
            frame[s.slot, s.start : s.start + n] = np.arange(n)
        v, p = self.voices, self.pool
        t = lambda a, d=torch.int64: torch.as_tensor(  # noqa: E731
            a, dtype=d, device=device)
        speech = t(p.speech, torch.float32).reshape(-1)
        noise = t(p.noise, torch.float32).reshape(-1)
        sc, nc, so, no = (t(a) for a in (v.speech_clip, v.noise_clip,
                                          v.speech_off, v.noise_off))
        sg, ng = t(v.speech_gain, torch.float64), t(v.noise_gain,
                                                    torch.float64)
        iota = torch.arange(FRAME, device=device)
        dtype = torch.int16 if self.int16 else torch.float32
        out = torch.empty((self.slots, self.ticks * FRAME), dtype=dtype)
        for b0 in range(0, self.ticks, block):
            vm = t(voice[:, b0 : b0 + block])
            pos = t(frame[:, b0 : b0 + block])[..., None] * FRAME + iota
            s = torch.take(speech, sc[vm][..., None] * p.length
                           + (so[vm][..., None] + pos) % p.length)
            z = torch.take(noise, nc[vm][..., None] * p.length
                           + (no[vm][..., None] + pos) % p.length)
            x = to_grid(sg[vm][..., None] * s.double()
                        + ng[vm][..., None] * z.double())
            x = x.to(dtype) if self.int16 else (x / 32768.0).to(dtype)
            out[:, b0 * FRAME : (b0 + vm.shape[1]) * FRAME] = \
                x.reshape(self.slots, -1).cpu()
        return out.numpy()

    def session_input(self, s: Session) -> np.ndarray:
        """A finished session's input, float32 at /32768 scale."""
        x = self.audio[s.slot, s.start * FRAME : (s.start + s.frames) * FRAME]
        return x.astype(np.float32) / 32768.0 if self.int16 else x

    def finished(self, upto: int | None = None) -> list[Session]:
        """The sessions that end by tick `upto` (the schedule's end)."""
        upto = self.ticks if upto is None else upto
        return [s for s in self.sessions if s.start + s.frames <= upto]


def sample_sessions(sched: StreamSchedule, n: int, seed: int,
                    upto: int | None = None) -> list[Session]:
    """n of the sessions that finish by tick `upto` (the window's end),
    drawn from the seed, the longest of them always among them."""
    done = sched.finished(upto)
    if not done:
        raise ValueError("no session finishes in the window")
    longest = max(done, key=lambda s: s.frames)
    rest = [s for s in done if s is not longest]
    rng = rng_for(seed, SAMPLE)
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def sample_rows(streams: int, n: int, seed: int) -> np.ndarray:
    """n stream rows of a batch, drawn from the seed, in order."""
    return np.sort(rng_for(seed, SAMPLE).choice(streams, size=min(n, streams),
                                                replace=False))
