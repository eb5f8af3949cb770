"""The port's twins of the JAX package's ``examples/`` scripts, run as
``python -m repro_torch.examples.<name>``: ``quickstart``,
``serve_decode``, ``train_100m``, ``train_classifier`` and
``train_segmentation``. Each prints what its JAX twin prints, runs on
the card unless ``--device cpu`` is given, and has a ``main(argv=None,
...)`` that returns what it printed, unrounded; importing one runs
nothing."""
from __future__ import annotations

import argparse

import torch


def add_device(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu")


def resolve_device(ap: argparse.ArgumentParser, args) -> torch.device:
    """``--device`` as a ``torch.device``; a parse error (exit 2) when it
    is neither cuda nor cpu, or cuda without a card."""
    device = torch.device(args.device)
    if device.type not in ("cuda", "cpu"):
        ap.error(f"--device must be cuda or cpu, got {args.device!r}")
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA GPU is available here; pass "
                 "--device cpu to run on the CPU")
    return device


def on_device(tree_, device):
    """Every tensor of ``tree_`` (a pytree of dicts) moved to ``device``."""
    from .. import tree
    return tree.map(lambda t: t.to(device), tree_)


def staged(batch, device):
    """A host batch of numpy arrays as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
