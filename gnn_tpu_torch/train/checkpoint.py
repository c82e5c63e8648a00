"""Checkpointing: ``torch.save`` of params, optimizer state, the update
count, epoch and best validation F1 (the counterpart of
`gnn_tpu.train.checkpoint`). Atomic write (tmp + rename), so a crash
mid-save never corrupts the previous checkpoint.

The update count rides beside the optimizer state: optax keeps the lr
warmup's count inside ``opt_state``, ``torch.optim.Adam`` does not, so a
resume that restored only the optimizer would restart the warmup.

Across data-parallel ranks the payload is the same: every rank holds the
same parameters and Adam state, so rank 0 writes (`Trainer.save`) and
every rank reads."""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch


def checkpoint_path(ckpt_dir: str, name: str) -> str:
    return os.path.join(ckpt_dir, f"{name}_model.pt")


def save_checkpoint(ckpt_dir: str, params: dict, step: int = 0,
                    opt_state: Optional[dict] = None,
                    n_updates: Optional[int] = None, name: str = "best",
                    best_val: float = -1.0) -> str:
    """``opt_state`` and ``n_updates`` (optimizer updates taken) travel
    together: give both or neither."""
    if (opt_state is None) != (n_updates is None):
        raise ValueError("save_checkpoint needs opt_state and n_updates "
                         "together")
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_path(ckpt_dir, name)
    payload = {"params": {k: v.detach().cpu() for k, v in params.items()},
               "step": int(step), "best_val": float(best_val)}
    if opt_state is not None:
        payload["opt_state"] = opt_state
        payload["n_updates"] = int(n_updates)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(ckpt_dir: str, name: str = "best"
                    ) -> Tuple[dict, int, Optional[dict], float,
                               Optional[int]]:
    """Returns (params, step, opt_state, best_val, n_updates);
    ``opt_state`` and ``n_updates`` of a params-only checkpoint are
    None. A checkpoint with an optimizer state but no update count
    (written before the count was saved) raises: resuming it would
    restart the lr warmup."""
    path = checkpoint_path(ckpt_dir, name)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    opt_state = payload.get("opt_state")
    if opt_state is not None and "n_updates" not in payload:
        raise ValueError(f"{path} holds an optimizer state without its "
                         "update count; it cannot be resumed")
    return (payload["params"], payload["step"], opt_state,
            float(payload.get("best_val", -1.0)), payload.get("n_updates"))
