"""End-to-end enhancement pipeline: PCM in -> enhanced PCM out.

Composes the three stages that the reference interleaves per frame inside
`rnnoise_process_frame` (denoise.cpp:508-547):

  features.frontend.analyze_batch  (spectra, bands, pitch, comb, features)
  models.percepnet.PercepNet       (g, r prediction)
  enhance.enhance_spectra          (pitch filter, band gains, OLA)

batched over B streams, with every per-frame ring buffer carried in a
PipelineState, so one function serves offline batches and streaming
chunks of any frame count.

Entry points run on the CUDA card unless the caller passes device="cpu",
and raise when no card is there.  Scale convention is the inference one:
input PCM / 32768 (main.cpp:34).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from percepnet_tpu_torch import constants as C
from percepnet_tpu_torch import enhance
from percepnet_tpu_torch.features import frontend
from percepnet_tpu_torch.models import percepnet
from percepnet_tpu_torch.ops.dispatch import resolve_device


class PipelineState(NamedTuple):
    """Everything `DenoiseState` (denoise.cpp:61-85) carries, for B
    streams, on one device."""
    front: frontend.FrontendState
    model: percepnet.ModelState
    synthesis_mem: torch.Tensor      # [B, 480] OLA carry


def init_pipeline_state(batch: int = 1, *,
                        model_dtype: torch.dtype = torch.float32,
                        device: str | torch.device | None = None
                        ) -> PipelineState:
    """Fresh zero state for `batch` independent streams on `device` (the
    card unless device='cpu').

    model_dtype: dtype of the carried NN state; pass torch.bfloat16 when
    serving with enhance_chunk(compute_dtype=torch.bfloat16)."""
    dev = resolve_device(device)
    return PipelineState(
        front=frontend.init_state(batch, dev),
        model=percepnet.init_model_state(batch, dev, model_dtype),
        synthesis_mem=torch.zeros((batch, C.FRAME_SIZE), dtype=torch.float32,
                                  device=dev))


def _check_device(model: torch.nn.Module, state: PipelineState,
                  dev: torch.device) -> None:
    for what, t in (("model", next(model.parameters())),
                    ("state", state.synthesis_mem)):
        if t.device.type != dev.type:
            raise ValueError(f"{what} is on {t.device}, the call runs on "
                             f"{dev}; move it there first")


@torch.no_grad()
def enhance_chunk(model: percepnet.PercepNet, signal, state: PipelineState,
                  return_gr: bool = False, impl: str | None = None, *,
                  device: str | torch.device | None = None, **model_kw):
    """Enhance a batch of equal-length PCM chunks with carried state.

    Args:
      model: PercepNet on `device`.
      signal: [B, n_samples] f32 PCM at inference scale (/32768), numpy or
        tensor, n_samples a multiple of FRAME_SIZE; moved to `device`.
      state: carried PipelineState for the B streams, on `device`.
      return_gr: also return the per-frame (g, r) predictions.
      impl: 'ref' / 'cuda' op tier; None takes the device's (ops.dispatch).
      device: where the call runs: the card unless 'cpu'.
      model_kw: forwarded to PercepNet.forward (compat activations,
        log1p_features, compute_dtype).  compute_dtype=torch.bfloat16
        selects the bf16 serving tier for the whole call: bf16 DFT
        operands with f32 spectra, the comb kernel's bf16 store, the bf16
        model and recurrence (pair it with init_pipeline_state(...,
        model_dtype=torch.bfloat16)) and the bf16 inverse DFT.  Any other
        compute_dtype, float32 included, stays on the parity path.

    Returns:
      (pcm [B, n_samples], new_state), plus (g, r) [B, T, 34] each when
      return_gr.  As in the reference, output frame t is the enhanced
      version of input frame t - (FRAME_LOOKAHEAD+1): a fresh stream
      starts with zeros, and the caller keeps feeding (or flushes) to
      drain the lookahead.
    """
    dev = resolve_device(device)
    _check_device(model, state, dev)
    if isinstance(signal, np.ndarray):
        signal = torch.from_numpy(signal)
    signal = signal.to(device=dev, dtype=torch.float32)
    serving = model_kw.get("compute_dtype") == torch.bfloat16
    front, fstate = frontend.analyze_batch(signal, state.front,
                                           serving=serving, impl=impl)
    g, r, mstate = model(front["features"], state.model, **model_kw)
    pcm, mem = enhance.enhance_spectra(front, g, r, state.synthesis_mem,
                                       serving=serving)
    new_state = PipelineState(fstate, mstate, mem)
    if return_gr:
        return pcm, new_state, (g, r)
    return pcm, new_state


def enhance_utterance(model: percepnet.PercepNet, signal, *,
                      device: str | torch.device | None = None, **model_kw):
    """Enhance one whole utterance [n_samples] from a fresh state.

    Returns pcm [n_samples] on `device`, delayed by FRAME_LOOKAHEAD+1
    frames like the reference binary's output stream.
    """
    dev = resolve_device(device)
    if isinstance(signal, np.ndarray):
        signal = torch.from_numpy(signal)
    state = init_pipeline_state(
        1, model_dtype=model_kw.get("compute_dtype") or torch.float32,
        device=dev)
    pcm, _ = enhance_chunk(model, signal[None], state, device=dev,
                           **model_kw)
    return pcm[0]


def flush_frames() -> int:
    """Frames of zero input needed to drain the lookahead pipeline."""
    return C.FRAME_LOOKAHEAD + 1
