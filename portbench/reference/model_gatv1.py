"""The published GAT (Velickovic et al., arXiv:1710.10903) as the
configuration states it: per layer ``z = W x`` (no bias), per head
``el = a_dst . z_r`` on the layer's rows and ``er = a_src . z_c`` on its
columns, the scores ``lrelu_0.2(el[r] + er[c])`` over every sampled edge
and each row's self edge (counted once where the layer holds it), a
softmax over each row's edges, the weighted sum of ``z`` plus a per-head
bias, the residual projection of the second layer (with bias, before
the activation), then ELU over the concatenated heads with dropout, or
at the last layer the mean of its heads: the logits. No normalisation
and no classifier follow. Everything is float32 with TF32 off. The edge
products run in chunks of edges whose intermediates are recomputed in
the backward pass, so that a layer of millions of edges fits."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.numerics import linear, rounded

CHUNK = 1 << 17
SLOPE = 0.2


def _widths(config: dict) -> list:
    """``(heads, features a head)`` of each layer."""
    heads, last = config["heads"], len(config["orders"]) - 1
    return [(h, config["classes"] if i == last else config["nhid"] // h)
            for i, h in enumerate(heads)]


def param_spec(config: dict) -> list:
    if any(o != 1 for o in config["orders"]):
        raise ValueError("the published GAT has attention in every layer")
    out, f_in = [], config["n_feats"]
    for i, (h, d) in enumerate(_widths(config)):
        pre = f"layers.{i}."
        out += [(pre + "W.weight", (h * d, f_in), "weight"),
                (pre + "a_src", (h, d), "weight"),
                (pre + "a_dst", (h, d), "weight"),
                (pre + "bias", (h * d,), "zeros")]
        if i == 1 and i < len(config["orders"]) - 1:
            out += [(pre + "res.weight", (h * d, f_in), "weight"),
                    (pre + "res.bias", (h * d,), "zeros")]
        f_in = h * d
    return out


def prepare_layer(lay: dict, n_rows: int, n_cols: int, config: dict,
                  device) -> dict:
    """The layer's edges and each row's self edge, every pair once, in
    row order."""
    r = np.concatenate([np.asarray(lay["r"], np.int64),
                        np.arange(n_rows, dtype=np.int64)])
    c = np.concatenate([np.asarray(lay["c"], np.int64),
                        np.asarray(lay["self_pos"], np.int64)])
    key = np.unique(r * n_cols + c)
    return {"r": torch.as_tensor(key // n_cols).to(device),
            "c": torch.as_tensor(key % n_cols).to(device),
            "self_pos": torch.as_tensor(lay["self_pos"]).to(device),
            "n_rows": n_rows}


def _scores(el, er, r, c):
    return F.leaky_relu(el.index_select(0, r) + er.index_select(0, c),
                        SLOPE)


def _weighted(e, z, r, c, n_rows, heads, precision):
    n = z.shape[1]
    zc = rounded(z.index_select(0, c), precision).reshape(-1, heads,
                                                          n // heads)
    return z.new_zeros((n_rows, n)).index_add(
        0, r, (rounded(e, precision)[:, :, None] * zc).reshape(-1, n))


def attention(lay: dict, el, er, z, heads: int, precision: str):
    """``[n_rows, heads * d]``: each head's softmax-weighted sum of ``z``
    over the row's edges."""
    r, c, n_rows = lay["r"], lay["c"], lay["n_rows"]
    spans = [(s, min(s + CHUNK, r.shape[0]))
             for s in range(0, r.shape[0], CHUNK)]
    s = torch.cat([checkpoint(_scores, el, er, r[a:b], c[a:b],
                              use_reentrant=False) for a, b in spans])
    # the softmax shift: a row's largest score, outside the gradient
    m = torch.full((n_rows, heads), float("-inf"), device=s.device)
    m = m.scatter_reduce(0, r[:, None].expand(-1, heads), s.detach(),
                         "amax")
    e = torch.exp(s - m.index_select(0, r))
    den = e.new_zeros((n_rows, heads)).index_add(0, r, e)
    num = z.new_zeros((n_rows, z.shape[1]))
    for a, b in spans:
        num = num + checkpoint(_weighted, e[a:b], z, r[a:b], c[a:b],
                               n_rows, heads, precision,
                               use_reentrant=False)
    return (num.reshape(n_rows, heads, -1) / den[:, :, None]).reshape(
        n_rows, -1)


def _head_dot(z, a, precision):
    """Per head ``a_h . z[:, h]``: ``[n, heads]``."""
    h, d = a.shape
    return (rounded(z, precision).reshape(-1, h, d)
            * rounded(a, precision)).sum(-1)


def forward(params: dict, layers: list, x, drop, config: dict,
            precision: str):
    widths = _widths(config)
    for i, ((h, d), lay) in enumerate(zip(widths, layers)):
        pre = f"layers.{i}."
        w = params[pre + "W.weight"]
        # z = W x has no bias: float32 multiplies as the port does, the
        # control's TF32 product takes a zero bias
        z = (F.linear(x, w) if precision == "float32" else linear(
            x, w, torch.zeros(w.shape[0], device=x.device), precision))
        el = _head_dot(z.index_select(0, lay["self_pos"]),
                       params[pre + "a_dst"], precision)
        er = _head_dot(z, params[pre + "a_src"], precision)
        out = attention(lay, el, er, z, h, precision) + params[pre + "bias"]
        if pre + "res.weight" in params:
            out = out + linear(x.index_select(0, lay["self_pos"]),
                               params[pre + "res.weight"],
                               params[pre + "res.bias"], precision)
        if i == len(widths) - 1:
            x = out.reshape(-1, h, d).mean(dim=1)
        else:
            x = drop(F.elu(out), i)
    return x
