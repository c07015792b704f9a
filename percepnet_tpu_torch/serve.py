"""Multi-stream real-time serving: many concurrent 10 ms streams, one step.

A fixed-capacity slot pool holds each stream's carried PipelineState on
the card; attaching a stream claims a slot (zero state), detaching frees
it.  All slots step together in one batched `enhance_chunk` per tick,
whether or not they are occupied — occupancy only decides which outputs
are surfaced.  Only PCM crosses between host and card: the state stays on
the device from tick to tick.

Usage:
    srv = StreamingServer(model.to("cuda"), capacity=64)
    sid = srv.attach()
    srv.submit(sid, frame)           # stage one 10 ms frame (480 samples)
    outs = srv.step()                # advance ALL streams one frame
    srv.detach(sid)

With frames_per_tick=N, `submit` stages N*480 samples per stream and
`step` returns N frames per stream, in one batched call.
"""

from __future__ import annotations

import numpy as np
import torch

from percepnet_tpu_torch import constants as C
from percepnet_tpu_torch import pipeline
from percepnet_tpu_torch.ops.activations import sigmoid_approx, tansig_approx
from percepnet_tpu_torch.ops.dispatch import resolve_device, resolve_impl


class StreamingServer:
    """Fixed-capacity batched streaming enhancer.

    Not thread-safe; drive it from one event loop.  Output frames lag
    input by FRAME_LOOKAHEAD+1 frames (the reference's algorithmic delay);
    after a stream ends, feed `flush_frames()` zero frames to drain.
    """

    def __init__(self, model, capacity: int = 64, *, compat: bool = False,
                 mesh=None, model_dtype=None, log1p_features: bool = False,
                 frames_per_tick: int = 1, io_int16: bool = False,
                 device: str | torch.device | None = None):
        """model: PercepNet, on `device`.
        compat: the C runtime's table activations (parity with nnet_data
          exports).
        log1p_features: required for checkpoints trained with the log1p
          input compression (models.percepnet.compress_features).
        frames_per_tick: frames advanced per `step()`; adds
          frames_per_tick*10 ms of buffering latency.
        device: the card unless 'cpu'.
        mesh, model_dtype, io_int16: not ported yet; each raises
          NotImplementedError when given.
        """
        for name, given in (("mesh", mesh is not None),
                            ("model_dtype", model_dtype is not None),
                            ("io_int16", io_int16)):
            if given:
                raise NotImplementedError(
                    f"StreamingServer({name}=...) is not ported yet")
        if frames_per_tick < 1:
            raise ValueError(f"frames_per_tick must be >= 1, got "
                             f"{frames_per_tick}")
        self.device = resolve_device(device)
        self.capacity = capacity
        self.frames_per_tick = frames_per_tick
        self.model = model
        self._kw: dict = {"impl": resolve_impl(None, self.device),
                          "log1p_features": log1p_features}
        if compat:
            self._kw.update(act_tanh=tansig_approx,
                            act_sigmoid=sigmoid_approx)
        self._state = pipeline.init_pipeline_state(capacity,
                                                   device=self.device)
        self._free = list(range(capacity))[::-1]
        self._active: set[int] = set()
        self._inbuf = np.zeros((capacity, frames_per_tick * C.FRAME_SIZE),
                               np.float32)

    # --- stream lifecycle -------------------------------------------------
    def attach(self) -> int:
        """Claim a slot for a new stream; returns the stream id (slot)."""
        if not self._free:
            raise RuntimeError("server at capacity")
        sid = self._free.pop()
        self._active.add(sid)
        self._reset_slot(sid)
        return sid

    def detach(self, sid: int) -> None:
        self._active.discard(sid)
        self._free.append(sid)

    @torch.no_grad()
    def _reset_slot(self, sid: int) -> None:
        """Zero one slot's state on the device, leaving the others."""
        st = self._state
        for t in (*st.front, *st.model, st.synthesis_mem):
            t[sid] = 0
        self._inbuf[sid] = 0.0

    # --- ticking ----------------------------------------------------------
    def submit(self, sid: int, frame: np.ndarray) -> None:
        """Stage one tick of audio: frames_per_tick*480 float samples at
        /32768 scale; shorter submissions are zero-padded."""
        if sid not in self._active:
            raise KeyError(f"stream {sid} is not attached")
        n = self._inbuf.shape[1]
        frame = np.asarray(frame, np.float32)[:n]
        self._inbuf[sid, : len(frame)] = frame
        self._inbuf[sid, len(frame):] = 0.0

    def step(self) -> dict[int, np.ndarray]:
        """Advance every stream frames_per_tick frames in one batched
        call; returns {sid: enhanced samples [frames_per_tick*480]}.

        Slots without a submitted frame step on silence (their state still
        advances, like a dropped packet).
        """
        pcm, self._state = pipeline.enhance_chunk(
            self.model, self._inbuf, self._state, device=self.device,
            **self._kw)
        self._inbuf[:] = 0.0
        out = pcm.cpu().numpy()
        return {sid: out[sid] for sid in self._active}

    @staticmethod
    def flush_frames() -> int:
        return pipeline.flush_frames()
