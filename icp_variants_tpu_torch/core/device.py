"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. A CUDA device without a card raises: the
    port never carries on on the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "icp_variants_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run on the CPU"
        )
    return dev


def timing_event(device: torch.device):
    """A CUDA timing event recorded now on ``device``'s current stream of
    this thread; None on the CPU."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev
