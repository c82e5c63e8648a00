"""Checkpointing: ``torch.save`` of params, optimizer state, epoch and
best validation F1 (the counterpart of `gnn_tpu.train.checkpoint`).
Atomic write (tmp + rename), so a crash mid-save never corrupts the
previous checkpoint."""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch


def checkpoint_path(ckpt_dir: str, name: str) -> str:
    return os.path.join(ckpt_dir, f"{name}_model.pt")


def save_checkpoint(ckpt_dir: str, params: dict, step: int = 0,
                    opt_state: Optional[dict] = None, name: str = "best",
                    best_val: float = -1.0) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_path(ckpt_dir, name)
    payload = {"params": {k: v.detach().cpu() for k, v in params.items()},
               "step": int(step), "best_val": float(best_val)}
    if opt_state is not None:
        payload["opt_state"] = opt_state
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(ckpt_dir: str, name: str = "best"
                    ) -> Tuple[dict, int, Optional[dict], float]:
    """Returns (params, step, opt_state, best_val)."""
    payload = torch.load(checkpoint_path(ckpt_dir, name),
                         map_location="cpu", weights_only=True)
    return (payload["params"], payload["step"], payload.get("opt_state"),
            float(payload.get("best_val", -1.0)))
