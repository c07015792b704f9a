"""Train PercepNet on one CUDA card: the `rnn_train.py` equivalent.

Usage:
  python -m percepnet_tpu_torch train \\
      --train-filelist train.lst --dev-filelist dev.lst \\
      --config configs/dns_challenge.yaml --out-dir exp/run1

Filelists point at raw 138-float record files (featgen output).  Resumes
from the newest checkpoint in --out-dir, including one written by
`python -m percepnet_tpu train` (the same .npz format).  A resumed run
continues the data stream where the checkpoint left it when the corpus
is kept on the device or read by the Python loader; the native C++
loader (a corpus over --device-data-mb, the recipe-scale path) starts
its stream anew, as the JAX package does with every loader.  --pretrain
warm-starts params only (rnn_train.py:520-526).  Runs on the card unless
--device cpu.  --distributed and its flags are parsed, but data-parallel
training is not ported yet: they exit 2.
"""

from __future__ import annotations

import argparse
import logging
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m percepnet_tpu_torch train",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--train-filelist", required=True)
    ap.add_argument("--dev-filelist")
    ap.add_argument("--config", help="YAML config (DNS_Challenge.yaml keys)")
    ap.add_argument("--out-dir", default="exp")
    ap.add_argument("--pretrain", help="params .npz to warm-start from")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--coordinator", help="coordinator host:port")
    ap.add_argument("--num-processes", type=int)
    ap.add_argument("--process-id", type=int)
    ap.add_argument("--batch-size", type=int)
    ap.add_argument("--seq-len", type=int)
    ap.add_argument("--max-steps", type=int)
    ap.add_argument("--log1p-features", action="store_true",
                    help="log1p-compress energy features at the model "
                         "boundary (fixes the reference's saturated input "
                         "stack; enhance must pass --log1p too; not "
                         "exportable to the C++ runtime)")
    ap.add_argument("--gain-mse-weight", type=float,
                    help="extra linear-domain gain MSE loss term weight "
                         "(default 0 = reference-faithful loss; see "
                         "train.loss.percepnet_loss)")
    ap.add_argument("--log-interval", type=int)
    ap.add_argument("--no-tensorboard", action="store_true")
    ap.add_argument("--watchdog", type=float, metavar="SECS",
                    help="exit(17) if no step completes in SECS (wedged "
                         "device); run under a supervisor loop — restart "
                         "resumes from the last checkpoint")
    ap.add_argument("--device-data-mb", type=int, default=4096,
                    help="keep the whole record corpus resident on the "
                         "device when it fits in this budget (only the "
                         "batch indices cross from the host per step; "
                         "0 disables)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.distributed or args.coordinator or args.num_processes \
            or args.process_id is not None:
        print("data-parallel training is not ported yet (ROADMAP A15)",
              file=sys.stderr)
        raise SystemExit(2)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")

    from percepnet_tpu_torch.ops.dispatch import resolve_device
    from percepnet_tpu_torch.train import checkpoint as ckpt
    from percepnet_tpu_torch.train import datasets
    from percepnet_tpu_torch.train.trainer import Trainer, TrainConfig

    device = resolve_device(args.device)
    overrides = {"out_dir": args.out_dir}
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    if args.seq_len:
        overrides["seq_len"] = args.seq_len
    if args.max_steps:
        overrides["train_max_steps"] = args.max_steps
    if args.gain_mse_weight is not None:
        overrides["gain_mse_weight"] = args.gain_mse_weight
    if args.log1p_features:
        overrides["log1p_features"] = True
    if args.log_interval:
        overrides["log_interval_steps"] = args.log_interval
    if args.watchdog:
        overrides["watchdog_secs"] = args.watchdog
    cfg = (TrainConfig.from_yaml(args.config, **overrides)
           if args.config else TrainConfig(**overrides))

    log = logging.getLogger("percepnet_tpu_torch.train")
    resume = None if args.no_resume else ckpt.latest_checkpoint(cfg.out_dir)
    start = ckpt.checkpoint_step(resume) if resume else 0
    train_files = datasets.read_filelist(args.train_filelist)
    train_set = datasets.RecordListDataset(train_files, cfg.seq_len)
    dev_set = None
    if args.dev_filelist:
        dev_set = datasets.RecordListDataset(
            datasets.read_filelist(args.dev_filelist), cfg.seq_len)

    record_bytes = cfg.seq_len * 138 * 4
    total_mb = (len(train_set) + (len(dev_set) if dev_set else 0)) \
        * record_bytes // 2**20
    device_data = device_dev = None
    dev_batches = []
    if args.device_data_mb and total_mb <= args.device_data_mb:
        # the corpus on the device: one upload, then only the batch
        # indices cross from the host per step
        device_data = datasets.load_all_chunks(train_set)
        train_iter = datasets.index_iterator(
            len(train_set), cfg.batch_size, seed=cfg.seed,
            skip_batches=start)
        if dev_set:
            device_dev = datasets.load_all_chunks(dev_set)
            dev_batches = list(datasets.index_iterator(
                len(dev_set), cfg.batch_size, shuffle=False, epochs=1))
        log.info("device-resident corpus: %d MB, %d train + %d dev chunks",
                 total_mb, len(train_set), len(dev_set) if dev_set else 0)
    else:
        from percepnet_tpu_torch.io import native
        if native.available():
            train_iter = native.NativeBatchLoader(
                train_files, cfg.seq_len, cfg.batch_size, seed=cfg.seed)
            log.info("using native C++ batch loader (%d chunks)%s",
                     train_iter.num_chunks(),
                     "; its stream restarts on resume" if start else "")
        else:
            log.info("native IO library unavailable: using the Python "
                     "batch loader")
            train_iter = datasets.batch_iterator(
                train_set, cfg.batch_size, seed=cfg.seed,
                skip_batches=start)
        if dev_set:
            dev_batches = list(datasets.batch_iterator(
                dev_set, cfg.batch_size, shuffle=False, epochs=1))

    trainer = Trainer(cfg, train_iter, dev_batches,
                      tensorboard=not args.no_tensorboard,
                      device_data=device_data, device_dev=device_dev,
                      device=device)
    if resume:
        trainer.restore(resume)
    if args.pretrain and int(trainer.state.step) == 0:
        trainer.load_pretrained(args.pretrain)
    trainer.run()


if __name__ == "__main__":
    main()
