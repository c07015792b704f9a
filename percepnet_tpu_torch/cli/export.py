"""Export weights for C++ deployment: the `dump_percepnet.py` equivalent.

Usage:
  python -m percepnet_tpu_torch export checkpoint.npz src/nnet_data.cpp
  python -m percepnet_tpu_torch export model.pt weights.npz

The source is any format `enhance --weights` takes (.npz, .pt/.pth,
.cpp).  A .cpp destination is a drop-in `nnet_data.cpp` for the
reference build (dump_percepnet.py:128-155 layout), byte for byte what
the JAX package writes; an .npz destination is the params-only weight
file both packages load.  The conversion is numpy on the host; --device
is resolved as by every command (the card unless `cpu`), so the command
surface fails alike without a card.
"""

from __future__ import annotations

import argparse

from percepnet_tpu_torch.ops.dispatch import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m percepnet_tpu_torch export",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("src", help="checkpoint .npz / params .npz / torch .pt "
                                "/ nnet_data .cpp")
    ap.add_argument("dst", help="output: nnet_data .cpp or params .npz")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not args.dst.endswith((".cpp", ".npz")):
        ap.error("destination must end in .cpp or .npz")
    resolve_device(args.device)

    from percepnet_tpu_torch.cli.enhance import load_params
    model = load_params(args.src)
    if args.dst.endswith(".cpp"):
        from percepnet_tpu_torch.io.nnet_data import emit_nnet_data_cpp
        emit_nnet_data_cpp(model, args.dst)
    else:
        from percepnet_tpu_torch.io.flat_npz import save_params_npz
        save_params_npz(args.dst, model)
    print(f"wrote {args.dst}")


if __name__ == "__main__":
    main()
