"""Command dispatcher: python -m percepnet_tpu_torch <command> [args...].

The counterpart of `python -m percepnet_tpu`.  Every command runs on the
CUDA card unless given --device cpu (bench: on the card only)."""

from __future__ import annotations

import importlib
import sys

COMMANDS = {
    "enhance": ("percepnet_tpu_torch.cli.enhance", "main"),
    "evaluate": ("percepnet_tpu_torch.cli.evaluate", "main"),
    "featgen": ("percepnet_tpu_torch.cli.featgen", "main"),
    "export": ("percepnet_tpu_torch.cli.export", "main"),
    "bench": ("percepnet_tpu_torch.bench", "main"),
}
# commands of the JAX package that the port does not have yet
NOT_PORTED = ("train", "split-dataset", "bin2h5")


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m percepnet_tpu_torch <command> [args...]\n"
              "commands: " + " ".join(sorted(COMMANDS)))
        raise SystemExit(0 if argv else 2)
    cmd = argv[0]
    if cmd in NOT_PORTED:
        print(f"{cmd!r} is not ported to percepnet_tpu_torch yet; use "
              f"python -m percepnet_tpu {cmd}", file=sys.stderr)
        raise SystemExit(2)
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; commands: "
              + " ".join(sorted(COMMANDS)), file=sys.stderr)
        raise SystemExit(2)
    mod_name, fn_name = COMMANDS[cmd]
    getattr(importlib.import_module(mod_name), fn_name)(argv[1:])


if __name__ == "__main__":
    main()
