"""Device placement for the port.

The port runs on a CUDA card. The CPU is taken only when a caller asks
for it by name, as the CPU tests do: a missing card is an error, never a
silent fallback.
"""

import torch


def resolve_device(device=None):
    """`None` or "cuda" -> the current CUDA device (raises when CUDA is
    absent); "cpu" -> the CPU; a torch.device or "cuda:N" as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ds2i_torch needs a CUDA device and torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
