"""Wrappers, in the benchmark's own files, around the calls that
enhance_chunk makes into each layer of the program:

  frontend       features.frontend.analyze_batch
  model          the PercepNet module's forward
  synthesis      enhance.enhance_spectra
  enhance_chunk  pipeline.enhance_chunk (the server's call per tick)

Each wrapper does what the probe is set to:
  capture  hand the layer's output to a callback (the window keeps what
           `correct` compares: periods, features and the comb's band
           energies, g and r);
  spans    time the call on the host clock between two synchronizes;
  ranges   mark it with a record_function range for the profiler.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch


class Probe:
    """The wrappers' settings and what they recorded."""

    def __init__(self, device: torch.device):
        self.device = device
        self.capture = None              # callable(stage, output) or None
        self.spans = False
        self.ranges = False
        self.span_ms: dict[str, list[float]] = defaultdict(list)
        self._undo: list = []

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _wrap(self, stage: str, fn):
        def wrapped(*args, **kwargs):
            if self.spans:
                self._sync()
                t0 = time.perf_counter()
            if self.ranges or self.spans:
                with torch.profiler.record_function(f"bench:{stage}"):
                    out = fn(*args, **kwargs)
            else:
                out = fn(*args, **kwargs)
            if self.spans:
                self._sync()
                self.span_ms[stage].append(
                    (time.perf_counter() - t0) * 1e3)
            if self.capture is not None:
                self.capture(stage, out)
            return out
        return wrapped

    def install(self, *models) -> None:
        """Wrap the program's layer entry points and each model's
        forward."""
        from percepnet_tpu_torch import enhance, pipeline
        from percepnet_tpu_torch.features import frontend
        for mod, attr, stage in ((frontend, "analyze_batch", "frontend"),
                                 (enhance, "enhance_spectra", "synthesis"),
                                 (pipeline, "enhance_chunk",
                                  "enhance_chunk")):
            orig = getattr(mod, attr)
            setattr(mod, attr, self._wrap(stage, orig))
            self._undo.append((mod, attr, orig))
        for m in models:
            m.forward = self._wrap("model", m.forward)
            self._undo.append((m, "forward", None))

    def uninstall(self) -> None:
        for obj, attr, orig in reversed(self._undo):
            if orig is None:
                del obj.__dict__[attr]
            else:
                setattr(obj, attr, orig)
        self._undo.clear()
