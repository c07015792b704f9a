"""Train PercepNet on CUDA cards: the `rnn_train.py` equivalent.

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
--device cpu.

Data parallel: start one process per card with --distributed.  Pass
--coordinator host:port --num-processes N --process-id I, or nothing
more under torchrun, which sets MASTER_ADDR, MASTER_PORT, RANK and
WORLD_SIZE.  Rank I takes cuda:{I % device_count} and joins an NCCL
group (gloo with --device cpu); the group is left at exit.  Data is
sharded by rank: --batch-size is the PER-PROCESS batch, and the global
batch is batch_size * num_processes, the ranks' batches in rank order.
The corpus is kept on the device only in a world of one.  Every process
must take as many steps and dev batches (give each rank as many files),
or the collectives wait forever.  Only rank 0 writes to --out-dir.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

ENV_GROUP = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m percepnet_tpu_torch train",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--train-filelist", required=True)
    ap.add_argument("--dev-filelist")
    ap.add_argument("--config", help="YAML config (DNS_Challenge.yaml keys)")
    ap.add_argument("--out-dir", default="exp")
    ap.add_argument("--pretrain", help="params .npz to warm-start from")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--coordinator",
                    help="rank 0's host:port (omit under torchrun: read "
                         "from MASTER_ADDR and MASTER_PORT)")
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
    return ap


def _group(args) -> tuple[str, int, int]:
    """(coordinator, world size, rank) from the flags or, without
    --coordinator, from torchrun's environment; exits 2 when incomplete."""
    if args.coordinator:
        if args.num_processes is None or args.process_id is None:
            _refuse("--coordinator needs --num-processes and --process-id")
        return args.coordinator, args.num_processes, args.process_id
    if args.num_processes is not None or args.process_id is not None:
        _refuse("--num-processes and --process-id need --coordinator")
    missing = [k for k in ENV_GROUP if k not in os.environ]
    if missing:
        _refuse("--distributed needs --coordinator host:port "
                "--num-processes N --process-id I, or the environment "
                f"torchrun sets ({', '.join(missing)} missing)")
    env = os.environ
    return (f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
            int(env["WORLD_SIZE"]), int(env["RANK"]))


def _refuse(msg: str) -> None:
    print(f"train: {msg}", file=sys.stderr)
    raise SystemExit(2)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.distributed and (args.coordinator or args.num_processes
                                 is not None or args.process_id is not None):
        _refuse("--coordinator, --num-processes and --process-id need "
                "--distributed")
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    from percepnet_tpu_torch.ops.dispatch import resolve_device
    from percepnet_tpu_torch.parallel import mesh as pm

    if not args.distributed:
        train(args, resolve_device(args.device))
        return
    coordinator, world, rank = _group(args)
    device = pm.init_distributed(coordinator, world, rank,
                                 args.device or "cuda")
    try:
        train(args, device)
        pm.barrier()
    finally:
        pm.shutdown()


def train_stream(train_set, train_files, cfg, shard: int, nshards: int,
                 start: int):
    """This rank's stream of record batches (cfg.batch_size each), off the
    host: the native C++ loader when it builds (its stream restarts on
    resume), else the Python loader, continued past `start` batches."""
    from percepnet_tpu_torch.io import native
    from percepnet_tpu_torch.train import datasets
    log = logging.getLogger("percepnet_tpu_torch.train")
    if native.available():
        loader = native.NativeBatchLoader(
            train_files, cfg.seq_len, cfg.batch_size, shard_id=shard,
            num_shards=nshards, seed=cfg.seed)
        log.info("using native C++ batch loader (%d chunks)%s",
                 loader.num_chunks(),
                 "; its stream restarts on resume" if start else "")
        return loader
    log.info("native IO library unavailable: using the Python batch "
             "loader")
    return datasets.batch_iterator(train_set, cfg.batch_size, seed=cfg.seed,
                                   skip_batches=start)


def train(args, device):
    """Build the Trainer from parsed `args` on `device` and run it, in the
    process group if there is one (this process's rank and shard)."""
    from percepnet_tpu_torch.parallel import mesh as pm
    from percepnet_tpu_torch.train import checkpoint as ckpt
    from percepnet_tpu_torch.train import datasets
    from percepnet_tpu_torch.train.trainer import Trainer, TrainConfig

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
    shard, nshards = pm.process_index(), pm.process_count()
    train_files = datasets.read_filelist(args.train_filelist)
    train_set = datasets.RecordListDataset(
        train_files, cfg.seq_len, shard_id=shard, num_shards=nshards)
    dev_set = None
    if args.dev_filelist:
        dev_set = datasets.RecordListDataset(
            datasets.read_filelist(args.dev_filelist), cfg.seq_len,
            shard_id=shard, num_shards=nshards)

    record_bytes = cfg.seq_len * 138 * 4
    total_mb = (len(train_set) + (len(dev_set) if dev_set else 0)) \
        * record_bytes // 2**20
    device_data = device_dev = None
    dev_batches = []
    if args.device_data_mb and total_mb <= args.device_data_mb \
            and nshards == 1:
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
        train_iter = train_stream(train_set, train_files, cfg, shard,
                                  nshards, start)
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
