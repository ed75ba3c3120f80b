"""PyTorch/CUDA port of ``repro`` (RFF-KLMS and RFF-KRLS serving) for
NVIDIA Hopper.

The package mirrors ``repro``'s layout and public names so a reader can
find each counterpart: ``kernels/`` (plain PyTorch oracles, the CUDA
kernels' wrappers and the ``mode=`` dispatch), ``core/`` (feature maps,
the KLMS and KRLS filters and their bank), ``features/`` (the
affine-trig contract) and ``serve/`` (micro-batch queue, snapshot server,
``make_server``).

Entry points take ``device=`` and default to ``"cuda"``; without a CUDA
device they raise. The CPU is used only when the caller passes
``device="cpu"``, and then every kernel wrapper is replaced by its plain
PyTorch version. The port imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    there is none (no silent move to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the CUDA device by default and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path"
        )
    return dev
