"""Training loop: interval-driven train / eval / log / save, the port's
counterpart of percepnet_tpu/train/trainer.py.

Mirrors the reference Trainer (rnn_train.py:261-489): a step loop to
train_max_steps with eval, save and log intervals, but with full-state
checkpoints in the JAX package's format (train.checkpoint).

Data parallel is one process per card in a `torch.distributed` group
(parallel.mesh.init_distributed; `train --distributed`), where JAX runs
one SPMD program over an in-process mesh.  What the rank changes
follows JAX's Trainer: the state is broadcast from rank 0 after init,
restore and load_pretrained; each step averages the ranks' gradients
(train.state.train_step); evaluate averages over the ranks; only rank 0
writes config.yml, history.jsonl, TensorBoard and checkpoints; and
train_audio_s_per_s counts every rank's batch.

Config keys and defaults follow utils/DNS_Challenge.yaml.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import signal
import threading
import time
from typing import Any, Iterator

import numpy as np
import torch

from percepnet_tpu_torch.models.percepnet import PercepNet
from percepnet_tpu_torch.ops.dispatch import resolve_device
from percepnet_tpu_torch.parallel import mesh as pm
from percepnet_tpu_torch.train import checkpoint as ckpt
from percepnet_tpu_torch.train import datasets
from percepnet_tpu_torch.train import state as ts

log = logging.getLogger("percepnet_tpu_torch.train")


@dataclasses.dataclass
class TrainConfig:
    """utils/DNS_Challenge.yaml defaults + rnn_train.py argparse defaults
    (the JAX package's TrainConfig, field for field)."""
    batch_size: int = 64
    seq_len: int = 2000                  # --train_length_size
    learning_rate: float = 1e-4          # rnn_train.py:576
    train_max_steps: int = 100_000
    save_interval_steps: int = 1_000
    eval_interval_steps: int = 1_000
    log_interval_steps: int = 1_000
    grad_clip_norm: float | None = None  # reference does not clip
    gain_mse_weight: float = 0.0         # extra linear-domain gain MSE
                                         # term (see loss.percepnet_loss);
                                         # 0.0 = reference-faithful loss
    log1p_features: bool = False         # compress energy features at the
                                         # model boundary (models.percepnet.
                                         # compress_features); enhance with
                                         # the same flag; not exportable to
                                         # the C++ runtime
    seed: int = 0
    out_dir: str = "exp"
    watchdog_secs: float | None = None   # hang detection (see run())

    @classmethod
    def from_yaml(cls, path: str, **overrides) -> "TrainConfig":
        import yaml
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in raw.items() if k in known}
        kw.update(overrides)
        return cls(**kw)

    def dump(self, path: str) -> None:
        import yaml
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            yaml.safe_dump(dataclasses.asdict(self), f)


class Trainer:
    """Step-driven trainer on one device per process; resumable from
    full-state checkpoints."""

    def __init__(self, config: TrainConfig,
                 train_iter: Iterator[np.ndarray],
                 dev_batches: list[np.ndarray] | None = None,
                 tensorboard: bool = True,
                 device_data: np.ndarray | None = None,
                 device_dev: np.ndarray | None = None,
                 device: str | torch.device | None = None,
                 mesh: pm.Mesh | None = None):
        """device_data/device_dev: optional [N, T, 138] record arrays kept
        resident on the device (datasets.load_all_chunks).  With
        device_data set, `train_iter` must yield int32 INDEX batches
        (datasets.index_iterator) and `dev_batches` index batches into
        device_dev: only indices cross from the host per step.  One
        process only, as in JAX: in a process group each rank's loader
        yields its own shard of the records.
        device: the card unless "cpu" is asked for; raises without one.
        mesh: a 1-device mesh names the device; several devices raise
        (data parallel runs one process per card: `train
        --distributed`).
        In a process group, train_iter yields this rank's local batches
        of config.batch_size; the global batch is their concatenation in
        rank order."""
        if mesh is not None:
            if len(mesh) != 1:
                raise ValueError(
                    f"Trainer(mesh=) over {len(mesh)} devices: data-"
                    f"parallel training runs one process per card in a "
                    f"process group (python -m percepnet_tpu_torch train "
                    f"--distributed), not an in-process mesh")
            if device is not None and torch.device(device) != \
                    mesh.devices[0]:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.devices[0]}")
            device = mesh.devices[0]
        if device_data is not None and pm.process_count() > 1:
            raise ValueError("a device-resident corpus is single-process "
                             "only: in a process group each rank loads its "
                             "own shard")
        self.config = config
        self.train_iter = train_iter
        self.dev_batches = dev_batches or []
        self.device = resolve_device(device)
        self.mesh = pm.Mesh((self.device,))
        self.opt = ts.make_optimizer(config.learning_rate,
                                     config.grad_clip_norm)
        model = PercepNet(torch.Generator().manual_seed(config.seed))
        self.state = ts.init_train_state(model.to(self.device), self.opt)
        self._broadcast_state()
        self._device_mode = device_data is not None
        steps = (ts.make_index_steps if self._device_mode
                 else ts.make_steps)
        self._train_step, self._eval_step = steps(
            self.opt, gain_mse_weight=config.gain_mse_weight,
            log1p_features=config.log1p_features)
        if self._device_mode:
            self._xa, self._ya = self._put(device_data)
            self._dev_xa, self._dev_ya = (self._put(device_dev)
                                          if device_dev is not None
                                          else (None, None))
        self.history: list[dict[str, Any]] = []
        # TensorBoard scalars + intermediate-result heatmaps, like the
        # reference (rnn_train.py:431-462); optional dependency.
        self._tb = None
        if tensorboard and pm.process_index() == 0:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(os.path.join(config.out_dir, "tb"))
            except ImportError:
                log.info("tensorboard is not installed; no TB logs")

    def _put(self, records: np.ndarray):
        x, y = datasets.split_xy(records)
        (shard,) = pm.shard_batch(self.mesh, (np.ascontiguousarray(x),
                                              np.ascontiguousarray(y)))
        return shard

    def _broadcast_state(self) -> None:
        """Rank 0's parameters, optimizer state and step on every rank
        (JAX's pm.replicate); nothing without a process group."""
        st = self.state
        pm.broadcast_([*ts.parameters(st.model),
                       *(st.opt_state[k] for k in sorted(st.opt_state)),
                       st.step])

    def _indices(self, idx: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(idx, np.int64)).to(self.device)

    def _record(self, rec: dict[str, Any]) -> None:
        self.history.append(rec)
        if pm.process_index() != 0:
            return
        path = os.path.join(self.config.out_dir, "history.jsonl")
        os.makedirs(self.config.out_dir, exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            step = rec.get("step", 0)
            for k, v in rec.items():
                if k != "step" and isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, step)

    def _log_heatmaps(self, step: int) -> None:
        """Predicted vs target g/r heatmaps on the first dev batch
        (the reference's intermediate-result images, rnn_train.py:431-457)."""
        if self._tb is None or not self.dev_batches:
            return
        if self._device_mode:
            idx = self._indices(self.dev_batches[0][:1])
            x, y = self._dev_xa[idx], self._dev_ya[idx].cpu().numpy()
        else:
            x, y = self._put(self.dev_batches[0][:1])
            y = y.cpu().numpy()
        with torch.no_grad():
            g, r, _ = self.state.model(
                x, log1p_features=self.config.log1p_features)
        for name, pred, tgt in [("g", g[0], y[0, :, :34]),
                                ("r", r[0], y[0, :, 34:])]:
            self._tb.add_image(f"eval/{name}_predicted",
                               pred.cpu().numpy().T[None], step)
            self._tb.add_image(f"eval/{name}_target", tgt.T[None], step)

    # --- checkpointing ----------------------------------------------------
    def save(self) -> str:
        step = int(self.state.step)
        path = os.path.join(self.config.out_dir, f"checkpoint-{step}.npz")
        # the state is the same on every rank, so only rank 0 writes (the
        # ranks share out_dir)
        if pm.process_index() == 0:
            ckpt.save_checkpoint(path, self.state)
            log.info("saved %s", path)
        return path

    def restore(self, path: str | None = None) -> bool:
        path = path or ckpt.latest_checkpoint(self.config.out_dir)
        if not path:
            return False
        try:
            ckpt.load_checkpoint(path, self.state)
        except KeyError as e:
            # The opt_state layout depends on the optimizer config (clip,
            # apply_if_finite); a checkpoint written under another config
            # keeps its params and step and restarts the optimizer.
            log.warning(
                "checkpoint %s has a different opt_state layout than the "
                "current optimizer config (%s): restoring params and "
                "step, REINITIALIZING optimizer state (Adam moments "
                "restart; brief loss bump possible)", path, e)
            self._load_params(ckpt.load_params_from_checkpoint(path))
            self.state.opt_state = self.opt.init(self.state.model)
            self.state.step.fill_(ckpt.checkpoint_step(path))
        self._broadcast_state()
        log.info("restored %s (step %d)", path, int(self.state.step))
        return True

    def _load_params(self, model: PercepNet) -> None:
        with torch.no_grad():
            for dst, src in zip(ts.parameters(self.state.model),
                                ts.parameters(model)):
                dst.copy_(src)

    def load_pretrained(self, params_npz: str) -> None:
        """Warm-start params only (the reference's --pretrain path)."""
        self._load_params(ckpt.load_params_npz(params_npz))
        self._broadcast_state()

    # --- loops --------------------------------------------------------------
    def evaluate(self) -> float:
        """The dev batches' mean loss; in a process group each batch's
        loss is the mean over the ranks' local batches (every rank must
        hold as many dev batches)."""
        if not self.dev_batches:
            return float("nan")
        losses = []
        for b in self.dev_batches:
            if self._device_mode:
                loss = self._eval_step(self.state, self._dev_xa,
                                       self._dev_ya, self._indices(b))
            else:
                loss = self._eval_step(self.state, *self._put(b))
            losses.append(loss.reshape(1))
        losses = torch.cat(losses)
        pm.all_reduce_mean_([losses])
        return float(np.mean(losses.cpu().numpy().astype(np.float64)))

    def run(self) -> None:
        cfg = self.config
        if pm.process_index() == 0:
            cfg.dump(os.path.join(cfg.out_dir, "config.yml"))
        step = int(self.state.step)
        t0, steps0 = time.time(), step

        # Preemption safety (the reference loses progress since the last
        # interval save): SIGTERM/SIGINT request a checkpoint-and-exit at
        # the next step boundary; resume picks it up exactly.
        stop = {"now": False}

        def _on_signal(signum, frame):
            del frame
            log.warning("signal %d: checkpointing and stopping", signum)
            stop["now"] = True

        old_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old_handlers[sig] = signal.signal(sig, _on_signal)
            except ValueError:       # non-main thread
                pass

        # Hang detection: a wedged device can block a step forever, and a
        # stuck device op cannot be cancelled in-process, so the watchdog
        # hard-exits; a supervisor loop restarts the job and it resumes
        # from the last checkpoint.  Armed from loop entry, with a
        # generous first-step deadline (start-up, kernel builds and
        # corpus upload come first); watchdog_secs applies once the first
        # step completes.
        first_step_deadline = max(4 * (cfg.watchdog_secs or 0.0), 3600.0)
        heartbeat = {"t": time.time(), "first": True}
        if cfg.watchdog_secs:
            def _watch():
                while not stop["now"]:
                    time.sleep(min(cfg.watchdog_secs / 4, 30.0))
                    limit = (first_step_deadline if heartbeat["first"]
                             else cfg.watchdog_secs)
                    stale = time.time() - heartbeat["t"]
                    if stale > limit:
                        log.error(
                            "watchdog: no step completed in %.0f s "
                            "(device hang?) — exiting for supervised "
                            "restart+resume", stale)
                        os._exit(17)

            threading.Thread(target=_watch, daemon=True).start()
        try:
            while step < cfg.train_max_steps and not stop["now"]:
                batch = next(self.train_iter)
                if self._device_mode:
                    loss = self._train_step(self.state, self._xa, self._ya,
                                            self._indices(batch))
                else:
                    loss = self._train_step(self.state, *self._put(batch))
                step += 1
                # The heartbeat tracks COMPLETED device work, not
                # launches: a wedged device accepts queued work and
                # would keep a launch-side heartbeat fresh.  Reading the
                # loss waits for the step; doing so every few steps also
                # bounds how far the host runs ahead.  Step 1 always
                # waits, which drops the first-step deadline.
                if (step == steps0 + 1
                        or step % min(50, cfg.log_interval_steps) == 0):
                    loss.item()
                    heartbeat["t"] = time.time()
                    heartbeat["first"] = False
                if step % cfg.log_interval_steps == 0:
                    dt = time.time() - t0
                    sps = (step - steps0) / max(dt, 1e-9)
                    # the global batch: cfg.batch_size is per process
                    audio_s = (sps * cfg.batch_size * pm.process_count()
                               * cfg.seq_len * 480 / 48_000)
                    rec = {"step": step, "loss": float(loss),
                           "steps_per_s": round(sps, 3),
                           "train_audio_s_per_s": round(audio_s, 1)}
                    self._record(rec)
                    log.info("%s", rec)
                if step % cfg.eval_interval_steps == 0 and self.dev_batches:
                    ev = self.evaluate()
                    self._record({"step": step, "eval_loss": ev})
                    self._log_heatmaps(step)
                    log.info("eval step %d loss %.6f", step, ev)
                if step % cfg.save_interval_steps == 0:
                    self.save()
        finally:
            stop["now"] = True           # stand down the watchdog
            # always save a final checkpoint (rnn_train.py:644-650)
            self.save()
            if self._tb is not None:
                self._tb.flush()
            for sig, h in old_handlers.items():
                signal.signal(sig, h)
