"""The device of a benchmark or episode entry point (gridmm_tpu_torch/cli/
bench*.py, drive_episode.py, run_synthetic_eval.py).

They run on the card unless the caller asks for the CPU. A run that asks
for the card where there is none raises: nothing falls back to the CPU, so
no CPU number is ever reported under the card's name. (The JAX package's
utils/tpu_probe.py does the opposite on purpose, and has no counterpart.)
"""

from __future__ import annotations

import torch


def resolve(device: str = "cuda") -> torch.device:
    """`device` as a torch.device; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA card is visible; "
                           "pass --device cpu to run on the CPU")
    return dev


def sync(device: torch.device) -> None:
    """Wait for the work queued on `device` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def name(device: torch.device) -> str:
    """The card's name, or "cpu"."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
