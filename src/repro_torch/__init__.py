"""PyTorch/CUDA port of ``repro`` (the JAX package): serving, the MeCeFO
training step and Trainer, fault tolerance and state transfer, on one
process or over a (data, model) mesh of processes (``launch/mesh.py``,
``launch/dist.py``): training, prefill and decode.

The port keeps the JAX package's module names and tensor layouts at its
public functions, so every function here has a counterpart of the same name
under ``repro``.  It imports ``torch`` and never ``jax`` or ``repro``.

Entry points run on the card unless the caller asks for the CPU:
:func:`resolve_device` raises when CUDA is requested and absent, instead of
quietly carrying on on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; CUDA unless the caller says
    otherwise, and an error when CUDA is asked for but absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


__all__ = ["resolve_device"]
