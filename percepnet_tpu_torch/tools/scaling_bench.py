"""Data-parallel scaling-efficiency harness for the training step: the
counterpart of the JAX package's tools/scaling_bench.py.

Measures train-step throughput (audio-seconds/s) at world sizes 1, 2, 4,
... up to --max-world with a FIXED per-device batch (weak scaling), and
reports the efficiency against world 1.  The port's data parallelism is
one process per card (parallel.mesh.init_distributed; the step
all-reduces gradients and loss): for each world size this starts that
many worker processes on this host, rank r on cuda:r in an NCCL group (a
gloo group with --device cpu), each with a seeded PercepNet and seeded
uniform features and targets of --per-device-batch x --seq-len.  After
one warm-up step, --steps steps are timed on rank 0 between two
synchronizes; every step all-reduces, so the ranks move in lockstep.

  python -m percepnet_tpu_torch.tools.scaling_bench [--per-device-batch 32]
      [--seq-len 100] [--steps 10] [--max-world N]
  python -m percepnet_tpu_torch.tools.scaling_bench --device cpu \\
      --backend gloo --max-world 2        # validates the harness only

--max-world defaults to the cards this host has (2 with --device cpu).
NCCL takes one rank per card, so on a one-card host only world 1 is
measured, and the efficiency needs several cards; a world of gloo ranks
on the CPU validates the harness, not a card's number.  Prints one JSON
line per world size (devices, batch, audio_s_per_s, step_ms, and from
world 2 on efficiency_vs_1dev).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import torch

from percepnet_tpu_torch import constants as C
from percepnet_tpu_torch.tools import device_or_exit

WORKER_TIMEOUT_S = 900


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def worker(cfg: dict) -> None:
    """One rank: join the group, time the steps, and (rank 0) write the
    world's record to cfg['out']."""
    from percepnet_tpu_torch.models.percepnet import PercepNet
    from percepnet_tpu_torch.parallel import mesh as pm
    from percepnet_tpu_torch.train import state as ts

    if cfg["device"] == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // cfg["world"]))
    dev = pm.init_distributed(cfg["coordinator"], cfg["world"], cfg["rank"],
                              cfg["device"], backend=cfg["backend"])
    try:
        model = PercepNet(torch.Generator().manual_seed(0)).to(dev)
        opt = ts.make_optimizer(1e-4)
        state = ts.init_train_state(model, opt)
        gen = torch.Generator(device=dev).manual_seed(1 + cfg["rank"])
        shape = (cfg["per_device_batch"], cfg["seq_len"])
        feats = torch.rand((*shape, C.NB_FEATURES), generator=gen,
                           device=dev)
        targs = 0.9 * torch.rand((*shape, C.NB_TARGETS), generator=gen,
                                 device=dev)

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        loss = ts.train_step(state, feats, targs, opt)   # warm-up
        sync()
        pm.barrier()
        t0 = time.perf_counter()
        for _ in range(cfg["steps"]):
            loss = ts.train_step(state, feats, targs, opt)
        sync()
        dt = time.perf_counter() - t0
        if not bool(torch.isfinite(loss)):
            raise RuntimeError("the training loss is not finite")
        pm.barrier()
    finally:
        pm.shutdown()
    if cfg["rank"] == 0:
        batch = cfg["per_device_batch"] * cfg["world"]
        audio_s = (cfg["steps"] * batch * cfg["seq_len"] * C.FRAME_SIZE
                   / C.SAMPLE_RATE)
        with open(cfg["out"], "w") as f:
            json.dump({"devices": cfg["world"], "batch": batch,
                       "audio_s_per_s": audio_s / dt,
                       "step_ms": dt / cfg["steps"] * 1e3,
                       "backend": cfg["backend"], "device": str(dev)}, f)


def run_world(world: int, args, tmp: str) -> dict:
    """Start `world` ranks, wait for all of them, return rank 0's
    record; raises if any rank fails."""
    out = os.path.join(tmp, f"world{world}.json")
    coordinator = f"localhost:{_free_port()}"
    env = dict(os.environ)
    # the group's sockets stay on this host
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs = []
    try:
        for rank in range(world):
            cfg = {"coordinator": coordinator, "world": world, "rank": rank,
                   "device": args.device or "cuda", "backend": args.backend,
                   "per_device_batch": args.per_device_batch,
                   "seq_len": args.seq_len, "steps": args.steps, "out": out}
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "percepnet_tpu_torch.tools.scaling_bench", "--worker",
                 json.dumps(cfg)], env=env))
        codes = [p.wait(timeout=WORKER_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        raise RuntimeError(f"world {world}: ranks exited with {codes}")
    with open(out) as f:
        return json.load(f)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m percepnet_tpu_torch.tools.scaling_bench",
        description=__doc__.splitlines()[0])
    ap.add_argument("--per-device-batch", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=100)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--max-world", type=int,
                    help="largest world size (default: this host's cards; "
                         "2 with --device cpu)")
    ap.add_argument("--backend", choices=("nccl", "gloo"),
                    help="default: nccl on the card, gloo on the CPU")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(json.loads(args.worker))
        return []
    dev = device_or_exit("scaling_bench", args.device)
    args.backend = args.backend or ("nccl" if dev.type == "cuda" else "gloo")
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    max_world = args.max_world or (cards if dev.type == "cuda" else 2)
    if args.backend == "nccl" and max_world > cards:
        ap.error(f"NCCL takes one rank per card: --max-world {max_world} "
                 f"on {cards} card(s)")

    counts, n = [], 1
    while n <= max_world:
        counts.append(n)
        n *= 2
    if counts[-1] != max_world:
        counts.append(max_world)
    if dev.type == "cuda":
        from percepnet_tpu_torch.bench import card_label
        where = f"{cards} x {card_label()}"
    else:
        where = "cpu (harness validation, not a card's number)"
    print(f"# {where} | {args.backend} | per-device batch "
          f"{args.per_device_batch} x {args.seq_len} | {args.steps} steps",
          flush=True)
    if max_world == 1:
        print("# world 1 only: weak-scaling efficiency needs several "
              "devices", flush=True)

    results = []
    with tempfile.TemporaryDirectory(prefix="scaling_bench_") as tmp:
        for world in counts:
            rec = run_world(world, args, tmp)
            if results:
                base = results[0]
                rec["efficiency_vs_1dev"] = rec["audio_s_per_s"] / (
                    base["audio_s_per_s"] * world / base["devices"])
            results.append(rec)
            print(json.dumps(rec), flush=True)
    return results


if __name__ == "__main__":
    main()
