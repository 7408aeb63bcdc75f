"""Device choice for the PyTorch port.

Every entry point of the port (``Engine``, ``hybrid_spmm``,
``gcn_forward``, the kernel wrappers) takes a ``device`` that defaults
to ``"cuda"`` and resolves it here. Without a card the call raises
unless the caller asked for the CPU: the port never falls back to the
CPU on its own.
"""
from __future__ import annotations

import torch


def pin_ieee_f32() -> None:
    """Keep float32 products in full IEEE float32.

    Done for parity with the JAX reference, which computes in float32
    with float32 accumulation: TF32 keeps about three decimal digits and
    would put the port outside the tolerances its tests state.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.

    Raises ``RuntimeError`` for a CUDA device when no card is present;
    pass ``device="cpu"`` to run the plain PyTorch versions on the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: CUDA device requested but torch.cuda is not "
                "available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            # tensors report "cuda:<n>"; compare like with like
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', got {dev}")
    pin_ieee_f32()
    return dev
