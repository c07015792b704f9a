"""Checkpoints of the FULL train state (params + optimizer + step), in the
JAX package's format (percepnet_tpu/train/checkpoint.py): one .npz of flat
string-keyed arrays, `params/<layer>/<leaf>`, `opt_state/<optax path>`
and `step`, with the dtypes JAX writes (f32 arrays, int32 counters, a bool
`last_finite`).  A checkpoint written by either package resumes in the
other with its Adam moments and counters.

Params-only files (the deployment artifact) and the params half of a
checkpoint are io.flat_npz's.
"""

from __future__ import annotations

import os
import re
import tempfile

import numpy as np
import torch

from percepnet_tpu_torch.io import flat_npz
from percepnet_tpu_torch.train.state import LEAVES, TrainState, parameters

save_params_npz = flat_npz.save_params_npz
# a CPU PercepNet from a params-only file or a checkpoint's params/* keys,
# whatever optimizer layout the checkpoint has
load_params_npz = load_params_from_checkpoint = flat_npz.load_params


def state_to_flat(state: TrainState) -> dict[str, np.ndarray]:
    """The state as the flat arrays JAX's save_checkpoint writes."""
    out = flat_npz.params_to_flat(state.model)
    for key, value in state.opt_state.items():
        out[f"opt_state/{key}"] = value.cpu().numpy()
    out["step"] = state.step.cpu().numpy()
    return out


def save_checkpoint(path: str, state: TrainState) -> None:
    """Atomic write: a temp file in the target's directory, then a
    rename over the target."""
    out = state_to_flat(state)
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **out)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def load_checkpoint(path: str, state: TrainState) -> None:
    """Restore `state` in place from `path`, casting each array to the
    state's dtype and shape.  Raises KeyError when the file lacks a key
    the state has (another optimizer layout), before changing anything."""
    targets = {f"params/{layer}/{leaf}": t for (layer, leaf), t in
               zip(LEAVES, parameters(state.model))}
    targets.update({f"opt_state/{k}": v for k, v in state.opt_state.items()})
    targets["step"] = state.step
    with np.load(path) as z:
        missing = sorted(set(targets) - set(z.files))
        if missing:
            raise KeyError(f"{path} lacks {missing[:3]} "
                           f"({len(missing)} keys)")
        arrays = {k: z[k] for k in targets}
    with torch.no_grad():
        for key, t in targets.items():
            t.copy_(torch.from_numpy(np.asarray(arrays[key])).to(
                t.dtype).reshape(t.shape))


def checkpoint_step(path: str) -> int:
    """The step a checkpoint was saved at."""
    with np.load(path) as z:
        return int(z["step"])


_STEP_RE = re.compile(r"checkpoint-(\d+)\.npz$")


def latest_checkpoint(ckpt_dir: str) -> str | None:
    """Newest checkpoint-{step}.npz in a directory, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_step = None, -1
    for f in os.listdir(ckpt_dir):
        m = _STEP_RE.search(f)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(ckpt_dir, f), int(m.group(1))
    return best
