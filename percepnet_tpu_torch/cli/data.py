"""Dataset utilities: filelist split and f32 -> h5 conversion, the port's
copy of percepnet_tpu/cli/data.py (utils/split_feature_dataset.py and
utils/bin2h5.py).  Host file work: no device.

Usage:
  python -m percepnet_tpu_torch split-dataset feats/ --out-dir lists/ [--frac 0.8]
  python -m percepnet_tpu_torch bin2h5 records.f32 records.h5
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from percepnet_tpu_torch import constants as C


def split_main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m percepnet_tpu_torch split-dataset")
    ap.add_argument("feature_dir", help="directory of .f32/.out record files")
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--frac", type=float, default=0.8,
                    help="train fraction (split_feature_dataset.py:9)")
    args = ap.parse_args(argv)

    files = sorted(
        glob.glob(os.path.join(args.feature_dir, "*.f32"))
        + glob.glob(os.path.join(args.feature_dir, "*.out")))
    n = int(len(files) * args.frac)
    os.makedirs(args.out_dir, exist_ok=True)
    for name, subset in [("train_filelist.txt", files[:n]),
                         ("dev_filelist.txt", files[n:])]:
        path = os.path.join(args.out_dir, name)
        with open(path, "w") as f:
            f.write("\n".join(subset) + ("\n" if subset else ""))
        print(f"{path}: {len(subset)} files")


def bin2h5_main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m percepnet_tpu_torch bin2h5")
    ap.add_argument("src", help="raw float32 record file")
    ap.add_argument("dst", help="output .h5 (dataset name: data)")
    args = ap.parse_args(argv)

    from percepnet_tpu_torch.train.datasets import _h5py
    h5py = _h5py()
    x = np.fromfile(args.src, np.float32)
    t = x.shape[0] // C.RECORD_DIM
    x = x[: t * C.RECORD_DIM].reshape(t, C.RECORD_DIM)
    with h5py.File(args.dst, "w") as f:
        f.create_dataset("data", data=x)  # utils/bin2h5.py:10-12
    print(f"{args.dst}: {x.shape}")
