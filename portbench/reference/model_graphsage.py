"""GraphSAGE as the configuration states it (reference ``models.py`` of
HPC-Research-Lab/GNN): per layer ``concat([B x_self, W (A x)])``, ELU,
a per-row LayerNorm (biased variance + 1e-9), dropout; then the rows'
L2 normalisation, dropout and a linear classifier. ``A`` is the sampled
layer's ``D^-1 A`` times each column's debias weight. The configuration
states the hot block (edges whose two ends are both in the top
``hot_k`` set) in ``hot_dtype``: there, the edge values and the rows
they multiply are rounded to bfloat16, in the forward pass (``x *
debias``) and in the backward pass (the incoming gradient), with float32
products and sums; every other operation is float32 with TF32 off."""
from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F

from portbench.reference.numerics import linear, round_bf16


def param_spec(config: dict) -> list:
    """``(name, shape, init)`` of every parameter, in the model's order;
    ``init`` is ``weight`` (fan-in scaled normal), ``zeros`` or
    ``ones``."""
    nhid, f_in = config["nhid"], config["n_feats"]
    out = []
    for i, o in enumerate(config["orders"]):
        pre = f"encoder.layers.{i}."
        for lin in (["linearB", "linearW"] if o > 0 else ["linearW"]):
            out += [(pre + lin + ".weight", (nhid, f_in), "weight"),
                    (pre + lin + ".bias", (nhid,), "zeros")]
        out += [(pre + "scale", ((1 + o) * nhid,), "ones"),
                (pre + "offset", ((1 + o) * nhid,), "zeros")]
        f_in = (1 + o) * nhid
    out += [("linear.weight", (config["classes"], f_in), "weight"),
            ("linear.bias", (config["classes"],), "zeros")]
    return out


def _sparse(r, c, v, shape, device):
    """A coalesced COO matrix (its invariants hold by construction)."""
    idx = torch.stack([torch.as_tensor(r), torch.as_tensor(c)])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_coo_tensor(idx, torch.as_tensor(v), shape,
                                       device=device,
                                       check_invariants=False).coalesce()


def prepare_layer(lay: dict, n_rows: int, n_cols: int, config: dict,
                  device) -> dict:
    """A checked layer (`RefGraph.layer`) as device tensors: the cold
    edges' sparse matrix with values ``val * nf``, and the hot block's
    (values rounded to ``hot_dtype``) with its transpose."""
    hot = lay["hot"]
    cold = ~hot
    r, c, val, nf = lay["r"], lay["c"], lay["val"], lay["nf"]
    if config["hot_dtype"] != "bfloat16":
        raise ValueError("the reference knows a bfloat16 hot block")
    w_cold = torch.as_tensor(val[cold]) * torch.as_tensor(nf[c[cold]])
    a_cold = _sparse(r[cold], c[cold], w_cold, (n_rows, n_cols), device)
    w_hot = round_bf16(torch.as_tensor(val[hot]))
    a_hot = _sparse(r[hot], c[hot], w_hot, (n_rows, n_cols), device)
    a_hot_t = _sparse(c[hot], r[hot], w_hot, (n_cols, n_rows), device)
    return {"a_cold": a_cold, "a_hot": a_hot, "a_hot_t": a_hot_t,
            "nf": torch.as_tensor(nf).to(device),
            "self_pos": torch.as_tensor(lay["self_pos"]).to(device)}


class _HotAggregate(torch.autograd.Function):
    """``A_hot @ bf16(x * nf)``; backward ``nf * (A_hot^T @ bf16(g))``."""

    @staticmethod
    def forward(ctx, x, a_hot, a_hot_t, nf):
        ctx.save_for_backward(nf)
        ctx.a_hot_t = a_hot_t
        return torch.sparse.mm(a_hot, round_bf16(x * nf[:, None]))

    @staticmethod
    def backward(ctx, g):
        nf, = ctx.saved_tensors
        dx = torch.sparse.mm(ctx.a_hot_t, round_bf16(g))
        return dx * nf[:, None], None, None, None


def aggregate(lay: dict, x):
    return (torch.sparse.mm(lay["a_cold"], x)
            + _HotAggregate.apply(x, lay["a_hot"], lay["a_hot_t"],
                                  lay["nf"]))


def _layernorm(out, scale, offset):
    mean = out.mean(dim=1, keepdim=True)
    var = out.var(dim=1, unbiased=False, keepdim=True) + 1e-9
    return (out - mean) * scale * torch.rsqrt(var) + offset


def forward(params: dict, layers: list, x, drop, config: dict,
            precision: str):
    """Logits of the batch's target rows. ``drop(x, i)`` is the i-th
    dropout of the step."""
    for i, (o, lay) in enumerate(zip(config["orders"], layers)):
        pre = f"encoder.layers.{i}."

        def lin(name, h):
            return linear(h, params[pre + name + ".weight"],
                          params[pre + name + ".bias"], precision)
        if o > 0:
            agg = aggregate(lay, x)
            x_self = x.index_select(0, lay["self_pos"])
            h = torch.cat([lin("linearB", x_self), lin("linearW", agg)], 1)
        else:
            h = lin("linearW", x)
        x = drop(_layernorm(F.elu(h), params[pre + "scale"],
                            params[pre + "offset"]), i)
    norm = torch.sqrt((x * x).sum(dim=1, keepdim=True) + 1e-24)
    x = drop(x / norm.clamp_min(1e-12), len(layers))
    return linear(x, params["linear.weight"], params["linear.bias"],
                  precision)
