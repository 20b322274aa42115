"""Device resolution and the package's float32 policy.

Importing this module turns TF32 off for CUDA matrix products and cuDNN
convolutions: the port keeps full f32 numerics, as the JAX package's
HIGHEST-precision dots do, and has no TF32 path in this slice.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """`None` means "cuda" (the current card, by index). A CUDA request with no card raises: the port
    never falls back to the CPU on its own — ask for `device="cpu"`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (--device cpu) to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (use 'cuda' or 'cpu')")
    if dev.type == "cuda" and dev.index is None:
        # Name the card: tensors report cuda:N, and generators must match.
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
