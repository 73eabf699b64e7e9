"""Device resolution for the port's entry points.

Entry points take an explicit ``device`` that defaults to ``"cuda"``.  When
CUDA is absent they raise instead of running on the CPU; the CPU runs only
when the caller asks for it (the tests do).  A CUDA device without an index
resolves to the current card, by its index.  Resolving a CUDA device also
turns TF32 off for matmuls and convolutions, so the f32 path is real f32 as
in the JAX reference.
"""
from __future__ import annotations

from functools import lru_cache

import torch


@lru_cache(maxsize=64)
def const(values: tuple, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """A small constant tensor, uploaded once per (values, device, dtype).
    Building ``torch.tensor(values, device=cuda)`` in a loop would upload
    from pageable memory every time, which waits for the stream to drain.
    Callers must not modify the result."""
    return torch.tensor(values, dtype=dtype, device=device)


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "difusion_tpu_torch needs a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:
            # the card current now, named: tensors, streams and the caches
            # keyed by device stay on it when the current card changes
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    return dev
