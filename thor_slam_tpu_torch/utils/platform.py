"""Device selection and numeric precision pins.

A device is always explicit: a CUDA device, or ``"cpu"`` passed on purpose
(the parity tests do). Nothing here quietly drops to the CPU when no card
is visible.
"""

from __future__ import annotations

import torch


def select_device(device: str | torch.device | None = None) -> torch.device:
    """Resolve the compute device.

    ``None`` means the current CUDA device and raises when there is none;
    any explicit device (``"cuda:1"``, ``"cpu"``) is taken as given.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' explicitly to run the "
                "plain PyTorch path"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is visible")
    return dev


def pin_precision() -> None:
    """Full-f32 matmuls and convolutions, process-wide.

    The reference runs the whole tick at float32 matmul precision
    (``tracker.track_step``) and every KLT contraction at
    ``Precision.HIGHEST``. On the card TF32 would keep ~3 decimal digits of
    image intensities and world coordinates; cuDNN enables it by default.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
