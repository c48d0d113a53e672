"""materialize_tpu_torch — the PyTorch/CUDA port of materialize_tpu.

The JAX package (``materialize_tpu``) stays the reference; this package
re-implements its maintained-index slice on torch tensors, with the one
Pallas kernel of that path (the merge insertion-point search) redesigned
in CUDA C++ for Hopper as a merge-path merge that also writes the merged
run's source map and lanes (``csrc/merge_path.cu``).

Rules the whole package keeps:

- It imports ``torch`` and ``numpy`` only: never ``jax`` and nothing of
  ``materialize_tpu`` (it carries its own copies of the device-free
  pieces it needs).
- The device is explicit. Every entry point takes ``device=``, which
  defaults to ``"cuda"``; asking for CUDA without a card raises instead
  of carrying on on the CPU. Tests pass ``device="cpu"``.
- u64 lanes are carried as int64 in one storage form (see
  ``ops/lanes.py``): ``stored = u64_bits ^ (1 << 63)``, so a signed
  int64 compare orders them exactly as the reference's u64 compare.
"""

from __future__ import annotations

import torch


def default_device() -> str:
    """The device every entry point uses when the caller names none."""
    return "cuda"


def resolve_device(device=None) -> torch.device:
    """Turn a ``device=`` argument into a ``torch.device``; raises
    ``RuntimeError`` when CUDA is asked for and there is no card."""
    dev = torch.device(default_device() if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' explicitly to run the plain "
                "torch versions"
            )
        if dev.index is None:
            # "cuda" and "cuda:0" must compare equal to tensor devices.
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
