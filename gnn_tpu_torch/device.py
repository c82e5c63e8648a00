"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``; raises when CUDA is asked for and
    missing (nothing drops to the CPU quietly)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA was asked for but torch.cuda is not "
                               "available; pass device='cpu' (CLI: "
                               "--device cpu) to run on the CPU")
        # float32 matmuls and convolutions in full float32: TF32 keeps
        # about three decimal digits and would move the port's numbers
        # away from the JAX package's float32 math
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
