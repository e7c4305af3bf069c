"""Device resolution for the PyTorch port (counterpart of the JAX package's
``utils/tpu.py``).

Every entry point of the port takes a ``device`` argument that defaults to
``"cuda"``. Only an explicit ``device="cpu"`` runs on the CPU, where each
kernel wrapper takes its plain PyTorch version; asking for CUDA on a machine
without a card raises instead of dropping to the CPU. :func:`ensure_cuda`
is the counterpart of ``ensure_tpu``: a query that readies the card.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises if it names CUDA and no
    card is visible. On CUDA it also pins fp32 matrix products to true fp32
    (no TF32), the port's counterpart of JAX's ``Precision.HIGHEST``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def check_device(device, *tensors) -> torch.device:
    """Resolve ``device`` and require every tensor to lie on it."""
    dev = resolve_device(device)
    for t in tensors:
        if t is not None and t.device.type != dev.type:
            raise ValueError(f"tensor on {t.device} but device={device!r}")
    return dev


def ensure_cuda() -> bool:
    """True if a CUDA card is up, after building and loading the kernel
    library (``ops._build``), as ``ensure_tpu`` readies JAX's compilation
    cache; False on a host with no card, as ``ensure_tpu`` returns on a
    CPU host. A query, not a fallback: entry points still raise on
    ``device="cuda"`` without a card."""
    if not torch.cuda.is_available():
        return False
    from ..ops import _build
    _build.library()
    return True
