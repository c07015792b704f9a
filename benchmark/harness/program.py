"""A configuration's weights, and the program built from them.

The weights are the benchmark's: made on the device from the seed (one
uniform draw, scaled per leaf to PyTorch's default init bound, the law
the program's own init uses), or read from a checkpoint file that the
configuration names by path and SHA-256.  Program and reference are given
the same flat vector; each builds what it needs from it.
"""

from __future__ import annotations

import hashlib
import json
import math
import pathlib

import numpy as np
import torch

from benchmark.harness import traffic
from benchmark.reference import percepnet_ref as R


# the arithmetic of each part in the tiers the program offers
TIERS = (
    {"dft": "float32", "comb_store": "float32", "model": "float32",
     "pitch": "float32", "bands": "float32"},
    {"dft": "bfloat16", "comb_store": "bfloat16", "model": "bfloat16",
     "pitch": "float32", "bands": "float32"},
)
WIRES = ("float32", "int16")
ACTIVATIONS = "exact tanh and sigmoid"


def load_config(root: pathlib.Path, name: str) -> dict:
    """benchmark/configs/<name>.json, refused unless the harness builds
    and runs exactly what it states (check_config)."""
    with open(root / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    check_config(cfg)
    return cfg


def layers_of(arch: dict) -> list[tuple[str, str, tuple[int, ...]]]:
    """(layer, leaf, shape) of the network a configuration's
    "architecture" states, in the reference's LAYERS order."""
    out = []
    for layer in ("fc",):
        n_in, n_out = arch[layer]
        out += [(layer, "w", (n_in, n_out)), (layer, "b", (n_out,))]
    for layer in ("conv1", "conv2"):
        c = arch[layer]
        out += [(layer, "w", (c["kernel"], c["in"], c["out"])),
                (layer, "b", (c["out"],))]
    for layer in ("gru1", "gru2", "gru3", "gru_gb", "gru_rb"):
        n_in, n_h = arch[layer]
        out += [(layer, "wi", (n_in, 3 * n_h)), (layer, "wh", (n_h, 3 * n_h)),
                (layer, "bi", (3 * n_h,)), (layer, "bh", (3 * n_h,))]
    for layer in ("fc_gb", "fc_rb"):
        n_in, n_out = arch[layer]
        out += [(layer, "w", (n_in, n_out)), (layer, "b", (n_out,))]
    return out


def check_config(cfg: dict) -> None:
    """Raise ValueError unless the configuration states what the harness
    runs: the reference's (and the program's) widths and framing, one of
    the program's precision tiers, a wire it has, exact activations and
    raw-scale features.  A configuration the code cannot honour fails
    here instead of running something else."""
    arch = cfg["architecture"]
    stated = layers_of(arch)
    built = [(layer, leaf, tuple(shape)) for layer, leaf, shape in R.LAYERS]
    problems = []
    if len(stated) != len(built):
        problems.append(f"{len(stated)} leaves, not {len(built)}")
    problems += [f"{layer}/{leaf} {shape} (built {b})"
                 for (layer, leaf, shape), (_, _, b) in zip(stated, built)
                 if shape != b]
    matrices = sum(math.prod(s) for _, leaf, s in built if leaf[0] == "w")
    if arch["weights"] != matrices:
        problems.append(f"weights {arch['weights']} (the matrices hold "
                        f"{matrices})")
    for key, value in (("sample_rate", R.SAMPLE_RATE),
                       ("frame_samples", R.FRAME),
                       ("window_samples", R.WINDOW),
                       ("bands", R.NB_BANDS), ("input_features", 70),
                       ("comb_taps", 2 * R.COMB_M + 1),
                       ("lookahead_frames", R.LOOKAHEAD)):
        if arch[key] != value:
            problems.append(f"{key} {arch[key]} (the harness runs {value})")
    if cfg["precision"] not in TIERS:
        problems.append(f"precision {cfg['precision']} is no tier of the "
                        f"program's")
    if cfg["wire"] not in WIRES:
        problems.append(f"wire {cfg['wire']!r}")
    if cfg["activations"] != ACTIVATIONS:
        problems.append(f"activations {cfg['activations']!r}")
    if cfg["features"].get("raw_scale") is not True:
        problems.append("features other than raw-scale")
    if problems:
        raise ValueError(f"configuration {cfg.get('name')!r} states what "
                         f"the harness does not run: " + "; ".join(problems))


def _sha256(path: pathlib.Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def make_weights(cfg: dict, seed: int, device: torch.device,
                 repo: pathlib.Path) -> torch.Tensor:
    """The network's weights as one flat f32 vector on `device`, in the
    reference's LAYERS order."""
    src = cfg["weights"]
    if src["kind"] == "seeded-init":
        sizes = [math.prod(shape) for _, _, shape in R.LAYERS]
        bounds = torch.tensor([R.init_bound(layer, shape)
                               for layer, _, shape in R.LAYERS],
                              dtype=torch.float32, device=device)
        bound = torch.repeat_interleave(
            bounds, torch.tensor(sizes, device=device))
        gen = torch.Generator(device=device).manual_seed(
            traffic.torch_seed(seed, traffic.WEIGHTS))
        u = torch.rand(sum(sizes), generator=gen, device=device)
        return u * (2 * bound) - bound
    if src["kind"] == "checkpoint":
        path = repo / src["path"]
        if _sha256(path) != src["sha256"]:
            raise RuntimeError(f"{path} is not the checkpoint the "
                               f"configuration names (SHA-256 differs)")
        with np.load(path) as data:
            flat = np.concatenate([
                np.asarray(data[f"params/{layer}/{leaf}"], np.float32)
                .reshape(-1) for layer, leaf, _ in R.LAYERS])
        return torch.from_numpy(flat).to(device)
    raise ValueError(f"unknown weights kind {src['kind']!r}")


def bf16(cfg: dict) -> bool:
    return cfg["precision"]["model"] == "bfloat16"


def build_model(flat: torch.Tensor, cfg: dict):
    """The program's PercepNet holding the weights, on their device, and
    the enhance_chunk keywords of the configuration's tier."""
    from percepnet_tpu_torch.models.percepnet import PercepNet
    model = PercepNet(torch.Generator().manual_seed(0)).to(flat.device)
    with torch.no_grad():
        for (layer, leaf, shape), w in zip(R.LAYERS, _leaves(flat)):
            dst = getattr(model, layer)[leaf]
            if tuple(dst.shape) != shape:
                raise ValueError(f"{layer}/{leaf}: the program's shape "
                                 f"{tuple(dst.shape)}, the reference's "
                                 f"{shape}")
            dst.copy_(w)
    kw = {"log1p_features": cfg["features"]["log1p"]}
    if bf16(cfg):
        kw["compute_dtype"] = torch.bfloat16
    return model, kw


def _leaves(flat: torch.Tensor) -> list[torch.Tensor]:
    nested = R.unflatten(flat)
    return [nested[layer][leaf] for layer, leaf, _ in R.LAYERS]
