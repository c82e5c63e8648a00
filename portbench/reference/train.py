"""The reference's training steps, as the configuration states them:
the model's forward pass (``model_<name>.py``), the masked loss (sigmoid
BCE summed over classes, or softmax cross-entropy, a mean over the
batch's rows), the backward pass, the global-norm clip ``min(1, clip /
(norm + 1e-6))`` and Adam with the linear warm-up ``lr / 100 -> lr``.

Dropout draws its masks from a generator on the batch's device seeded
``program_seed * 1_000_003 + epoch`` at the start of each call of the
trainer's epoch, one ``[padded rows, width]`` draw a dropout in the
step's order: the randomness both sides take from the traffic's seed of
the program's draws."""
from __future__ import annotations

import importlib

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.graph import RefGraph, check_targets, levels


def model_module(config: dict):
    return importlib.import_module(
        f"portbench.reference.model_{config['model']}")


def make_params(config: dict, seed: int, device) -> dict:
    """The benchmark's initial parameters, made on ``device`` from
    ``seed`` in one draw: weights normal with standard deviation
    ``1 / sqrt(fan_in)``, clipped at two deviations; biases and
    LayerNorm offsets 0, LayerNorm scales 1."""
    spec = model_module(config).param_spec(config)
    g = torch.Generator(device=device).manual_seed(seed)
    n = sum(int(np.prod(s)) for _, s, k in spec if k == "weight")
    flat = torch.randn(n, generator=g, device=device)
    out, at = {}, 0
    for name, shape, kind in spec:
        if kind == "weight":
            size = int(np.prod(shape))
            std = 1.0 / float(shape[1]) ** 0.5
            w = flat[at:at + size].reshape(shape).clamp(-2.0, 2.0) * std
            out[name] = w.contiguous()
            at += size
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.ones(shape, device=device)
    return out


def prepare(config: dict, graph: RefGraph, batches: list, feats, device):
    """Every batch checked against the graph and moved to ``device``:
    per step the model's layers, the input rows' features and the
    targets' labels. Raises `BatchFault` where a batch is not a valid
    sample."""
    check_targets(graph, batches)
    mod = model_module(config)
    steps = []
    for b in batches:
        lv = levels(b)
        layers = []
        for l, o in enumerate(config["orders"]):
            if o == 0:
                if len(lv[l + 1]) != len(lv[l]) or not np.array_equal(
                        lv[l + 1], lv[l]):
                    raise ValueError("an order-0 layer changes its rows")
                layers.append(None)
                continue
            lay = graph.layer(lv[l + 1], lv[l], config["samp_num"])
            layers.append(mod.prepare_layer(lay, len(lv[l + 1]),
                                            len(lv[l]), config, device))
        x = torch.as_tensor(np.ascontiguousarray(feats[lv[0]]),
                            dtype=torch.float32).to(device)
        steps.append({"layers": layers, "x": x,
                      "labels": torch.as_tensor(graph.labels(lv[-1]))
                      .to(device),
                      "caps": b["caps"], "epoch": b["epoch"]})
    return steps


def masked_loss(logits, labels, config: dict, fault: str = ""):
    """The mean over the batch's rows of the configuration's loss;
    ``fault="half_batch"`` takes the mean over the first half alone."""
    if fault == "half_batch":
        half = max(1, logits.shape[0] // 2)
        logits, labels = logits[:half], labels[:half]
    if config["loss"] == "sigmoid_bce":
        per = (logits.clamp_min(0) - logits * labels
               + torch.log1p(torch.exp(-logits.abs()))).sum(1)
    else:
        per = -(labels * F.log_softmax(logits, dim=1)).sum(1)
    return per.mean()


def lr_at(config: dict, count: int) -> float:
    lr, warm = config["lr"], config["lr_warmup_steps"]
    if warm <= 0:
        return lr
    return lr / 100.0 + (lr - lr / 100.0) * min(count, warm) / warm


def follow(config: dict, params0: dict, steps: list,
           precision: str = "float32", fault: str = "") -> dict:
    """Run ``steps`` (from :func:`prepare`) from ``params0``: each step's
    loss, the first step's clipped gradient by leaf, and the parameters
    after the last step. ``fault`` plants a fault: ``half_batch`` (see
    :func:`masked_loss`) or ``stale_step`` (the last step reads the step
    before's batch, as a replay step reading a stale static buffer
    would)."""
    mod = model_module(config)
    names = list(params0)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2, eps = (config["adam"]["beta1"], config["adam"]["beta2"],
                   config["adam"]["eps"])
    p_drop = config["dropout"]
    losses, first = [], None
    gen, epoch = None, None
    for t, st in enumerate(steps):
        if fault == "stale_step" and t == len(steps) - 1 and t > 0:
            st = dict(steps[t - 1], epoch=st["epoch"])
        if st["epoch"] != epoch:
            epoch = st["epoch"]
            gen = torch.Generator(device=st["x"].device)
            gen.manual_seed(config["program_seed"] * 1_000_003 + epoch)
        caps = st["caps"]

        def drop(h, i):
            return _dropout(h, gen, p_drop, caps[min(i, len(caps) - 1)])
        logits = mod.forward(params, st["layers"], st["x"], drop, config,
                             precision)
        loss = masked_loss(logits, st["labels"], config, fault)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        scale = torch.clamp(config["grad_clip"] / (norm + 1e-6), max=1.0)
        grads = [g * scale for g in grads]
        if first is None:
            first = {k: g.detach().clone() for k, g in zip(names, grads)}
        lr = lr_at(config, t)
        with torch.no_grad():
            for k, g in zip(names, grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                c1 = 1 - b1 ** (t + 1)
                c2 = 1 - b2 ** (t + 1)
                denom = (v2[k].sqrt() / c2 ** 0.5).add_(eps)
                params[k].addcdiv_(m[k], denom, value=-lr / c1)
        losses.append(float(loss.detach()))
    return {"losses": losses, "first_grad": first,
            "params": {k: v.detach() for k, v in params.items()}}


def _dropout(x, generator, p, cap_rows):
    from portbench.reference.numerics import dropout
    if p == 0.0:
        return x
    return dropout(x, generator, p, cap_rows)
