"""room_slam_torch: the PyTorch/CUDA port of room_slam_tpu.

Turns movement traces into labeled 3D room boxes on an NVIDIA H100. The
JAX package ``room_slam_tpu`` stays the reference; this package imports
nothing from it (importing it would import jax) and keeps its own copies of
the host code it needs.

Entry points take ``device="cuda"`` by default and raise when no card is
present: they never fall back to the CPU unless ``device="cpu"`` is asked
for explicitly (the CPU tests do).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it is a CUDA device
    and no card is present.

    Also pins float32 matmuls and convolutions to full float32: the JAX
    reference computes in float32, and TF32 (about three decimal digits)
    would put the port out of tolerance against it."""
    # imported here, not with the package: the UDP tools (data/ingest.py's
    # listen, record, replay) run without torch's seconds of import
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "room_slam_torch: CUDA device requested but torch.cuda is not "
            "available; pass device='cpu' to run on the CPU explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
