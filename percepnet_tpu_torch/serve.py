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

The bf16 serving tier, with int16 PCM on the wire:
    srv = StreamingServer(model, capacity=64, model_dtype=torch.bfloat16,
                          io_int16=True, log1p_features=True)

Over a device mesh (JAX's StreamingServer(mesh=...)): the slots split
into len(mesh) contiguous blocks, one per shard device, each with its
own copy of the model and its own PipelineState; a tick launches every
shard's enhance_chunk before it copies any result back:
    srv = StreamingServer(model, capacity=64,
                          mesh=parallel.make_mesh())   # every card
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from percepnet_tpu_torch import constants as C
from percepnet_tpu_torch import pipeline
from percepnet_tpu_torch.ops.activations import sigmoid_approx, tansig_approx
from percepnet_tpu_torch.ops.dispatch import resolve_device, resolve_impl
from percepnet_tpu_torch.parallel import mesh as pm


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
        model_dtype: torch.bfloat16 serves the bf16 tier
          (pipeline.enhance_chunk(compute_dtype=...)) from the server's
          own bf16 copy of the model, with the carried state in bf16;
          None or torch.float32 serves f32.
        io_int16: audio crosses between host and card as int16 PCM:
          submit takes raw int16 samples and step returns int16.  The
          /32768 scaling and the C-cast truncation of the output (clip to
          the int16 range, round toward zero) happen on the device.
        device: the card unless 'cpu'.
        mesh: a parallel.Mesh: the slots shard over its devices
          (capacity must divide by len(mesh)) and the model is copied to
          each; `device` must then be None.  Without one, the server runs
          on `device` with the model it is given.
        """
        if mesh is not None and device is not None:
            raise ValueError("pass a mesh or a device, not both")
        if mesh is not None and capacity % len(mesh):
            raise ValueError(f"capacity {capacity} does not divide across "
                             f"a mesh of {len(mesh)}")
        if model_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"model_dtype must be None, torch.float32 or "
                             f"torch.bfloat16, got {model_dtype!r}")
        if frames_per_tick < 1:
            raise ValueError(f"frames_per_tick must be >= 1, got "
                             f"{frames_per_tick}")
        self.capacity = capacity
        self.frames_per_tick = frames_per_tick
        self.model_dtype = model_dtype or torch.float32
        self.io_int16 = io_int16
        self._kw: dict = {"log1p_features": log1p_features}
        if compat:
            self._kw.update(act_tanh=tansig_approx,
                            act_sigmoid=sigmoid_approx)
        bf16 = self.model_dtype == torch.bfloat16
        if bf16:
            self._kw["compute_dtype"] = self.model_dtype
        if mesh is None:
            self.device = resolve_device(device)
            mesh = pm.Mesh((self.device,))
            # bf16: cast once here, so that no tick pays for it
            self._models = [copy.deepcopy(model).to(self.model_dtype)
                            if bf16 else model]
        else:
            self.device = None
            self._models = [m.to(self.model_dtype)
                            for m in pm.replicate(mesh, model)]
        self.mesh = mesh
        self.model = self._models[0]
        self._ranges = pm.batch_sharding(mesh, capacity)
        self._impls = [resolve_impl(None, d) for d in mesh.devices]
        # one block of capacity / len(mesh) slots per shard
        self._states = [pipeline.init_pipeline_state(
            sl.stop - sl.start, model_dtype=self.model_dtype, device=d)
            for sl, d in zip(self._ranges, mesh.devices)]
        self._free = list(range(capacity))[::-1]
        self._active: set[int] = set()
        self._inbuf = np.zeros((capacity, frames_per_tick * C.FRAME_SIZE),
                               np.int16 if io_int16 else np.float32)

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

    def _shard_of(self, sid: int) -> tuple[int, int]:
        """A slot id's (shard, slot within the shard)."""
        return divmod(sid, self.capacity // len(self.mesh))

    @torch.no_grad()
    def _reset_slot(self, sid: int) -> None:
        """Zero one slot's state on its device, leaving the others."""
        shard, local = self._shard_of(sid)
        st = self._states[shard]
        for t in (*st.front, *st.model, st.synthesis_mem):
            t[local] = 0
        self._inbuf[sid] = 0.0

    # --- ticking ----------------------------------------------------------
    def submit(self, sid: int, frame: np.ndarray) -> None:
        """Stage one tick of audio: frames_per_tick*480 samples, float at
        /32768 scale, or raw int16 PCM when io_int16; shorter submissions
        are zero-padded."""
        if sid not in self._active:
            raise KeyError(f"stream {sid} is not attached")
        n = self._inbuf.shape[1]
        frame = np.asarray(frame, self._inbuf.dtype)[:n]
        self._inbuf[sid, : len(frame)] = frame
        self._inbuf[sid, len(frame):] = 0.0

    def step(self) -> dict[int, np.ndarray]:
        """Advance every stream frames_per_tick frames, one batched call
        per shard; returns {sid: enhanced samples [frames_per_tick*480]},
        f32 or, with io_int16, int16.

        Slots without a submitted frame step on silence (their state still
        advances, like a dropped packet).  Every shard's call is launched
        before any result is copied back.
        """
        pcms = []
        for i, (sl, dev) in enumerate(zip(self._ranges, self.mesh.devices)):
            signal = torch.from_numpy(self._inbuf[sl]).to(dev)
            if self.io_int16:
                signal = signal.to(torch.float32) * (1.0 / 32768.0)
            pcm, self._states[i] = pipeline.enhance_chunk(
                self._models[i], signal, self._states[i], impl=self._impls[i],
                device=dev, **self._kw)
            if self.io_int16:
                # the C cast: float -> int truncates toward zero in torch
                pcm = torch.clamp(pcm * 32768.0, -32768.0, 32767.0).to(
                    torch.int16)
            pcms.append(pcm)
        self._inbuf[:] = 0.0
        out = np.concatenate([p.cpu().numpy() for p in pcms])
        return {sid: out[sid] for sid in self._active}

    @staticmethod
    def flush_frames() -> int:
        return pipeline.flush_frames()
