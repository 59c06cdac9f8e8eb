"""aegis_tpu_torch — the PyTorch / CUDA port of aegis_tpu.

The JAX package ``aegis_tpu`` is the reference; this package mirrors its
layout and names (``core/dsp.py`` here is the counterpart of
``aegis_tpu/core/dsp.py``) and is held against it by the
``tests/test_torch_*.py`` parity tests.  It imports ``torch`` and never
``jax``: of ``aegis_tpu`` it imports only modules that are pure NumPy or
C++ (config, filters, the ``ref`` oracles, events helpers, io, midi, tempo,
signal generators, metrics, logging).

Device code is plain tensor code on an explicit ``device``; the pYIN
Viterbi decode runs as hand-written CUDA kernels (``csrc/viterbi.cu``) on a
CUDA tensor and as their plain PyTorch versions on a CPU tensor.
"""

from __future__ import annotations

__version__ = "0.1.0"

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch.device to run on.  Asking for CUDA where
    ``torch.cuda.is_available()`` is False raises: there is no silent CPU
    run.  On CUDA, TF32 is switched off for matmuls and cuDNN, so float32
    work stays full float32 like the JAX package's CPU reference."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda | cpu)")
    return dev
