"""What the port's examples share: the ``--device`` flag (the card unless
the caller asks for the host) and a synchronize that ends a timed phase."""
from __future__ import annotations

import argparse

import torch

__all__ = ["add_device_arg", "device_of", "sync"]


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="torch device the example runs on (default "
                        "cuda: the card; cpu: the host)")


def device_of(args: argparse.Namespace) -> torch.device:
    """The example's device; a CUDA device without a card raises."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device (pass "
                           "--device cpu to run on the host)")
    return dev


def sync(device) -> None:
    """Wait for the device's queued work (a no-op on the host)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
