"""GAT as the configuration states it: per layer ``q, k, v`` and
``self`` dense layers, one head of scaled dot-product attention over the
sampled layer's edges (scores ``q_r . k_c / sqrt(d)``, a softmax over
each row's edges, the weighted sum of ``v``), ``elu(agg + self(x_r))``,
dropout; then the rows' L2 normalisation, dropout and a linear
classifier (the TransformerConv form, Shi et al., arXiv:2009.03509).
Everything is float32 with TF32 off. The edge products run in chunks of
edges whose intermediates are recomputed in the backward pass, so that
a layer of millions of edges fits."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.numerics import linear, rounded

CHUNK = 1 << 18


def param_spec(config: dict) -> list:
    nhid, f_in = config["nhid"], config["n_feats"]
    out = []
    for i, o in enumerate(config["orders"]):
        pre = f"encoder.layers.{i}."
        names = ["q.", "k.", "v.", "self."] if o > 0 else [""]
        for nm in names:
            out += [(pre + nm + "weight", (nhid, f_in), "weight"),
                    (pre + nm + "bias", (nhid,), "zeros")]
        f_in = nhid
    out += [("linear.weight", (config["classes"], f_in), "weight"),
            ("linear.bias", (config["classes"],), "zeros")]
    return out


def prepare_layer(lay: dict, n_rows: int, n_cols: int, config: dict,
                  device) -> dict:
    if config.get("heads", 1) != 1:
        raise ValueError("the reference knows one attention head")
    return {"r": torch.as_tensor(lay["r"]).to(device),
            "c": torch.as_tensor(lay["c"]).to(device),
            "self_pos": torch.as_tensor(lay["self_pos"]).to(device),
            "n_rows": n_rows}


def _scores(q_r, k, r, c, scale, precision):
    return (rounded(q_r.index_select(0, r), precision)
            * rounded(k.index_select(0, c), precision)).sum(1) * scale


def _weighted(e, v, r, c, n_rows, precision):
    return v.new_zeros((n_rows, v.shape[1])).index_add(
        0, r, rounded(e[:, None], precision)
        * rounded(v.index_select(0, c), precision))


def attention(lay: dict, q_r, k, v, precision: str):
    r, c, n_rows = lay["r"], lay["c"], lay["n_rows"]
    d = k.shape[1]
    scale = float(np.float32(1.0) / np.sqrt(np.float32(d)))
    spans = [(s, min(s + CHUNK, r.shape[0]))
             for s in range(0, r.shape[0], CHUNK)]
    s = torch.cat([checkpoint(_scores, q_r, k, r[a:b], c[a:b], scale,
                              precision, use_reentrant=False)
                   for a, b in spans]) if spans else q_r.new_zeros(0)
    # the softmax shift: a row's largest score, outside the gradient
    m = torch.full((n_rows,), float("-inf"), device=s.device)
    m = m.scatter_reduce(0, r, s.detach(), "amax")
    e = torch.exp(s - m.index_select(0, r))
    den = e.new_zeros(n_rows).index_add(0, r, e)
    num = v.new_zeros((n_rows, v.shape[1]))
    for a, b in spans:
        num = num + checkpoint(_weighted, e[a:b], v, r[a:b], c[a:b],
                               n_rows, precision, use_reentrant=False)
    den = torch.where(den > 0, den, torch.ones((), device=den.device))
    return num / den[:, None]


def forward(params: dict, layers: list, x, drop, config: dict,
            precision: str):
    for i, (o, lay) in enumerate(zip(config["orders"], layers)):
        pre = f"encoder.layers.{i}."

        def lin(name, h):
            return linear(h, params[pre + name + "weight"],
                          params[pre + name + "bias"], precision)
        if o > 0:
            x_r = x.index_select(0, lay["self_pos"])
            agg = attention(lay, lin("q.", x_r), lin("k.", x),
                            lin("v.", x), precision)
            x = F.elu(agg + lin("self.", x_r))
        else:
            x = F.elu(lin("", x))
        x = drop(x, i)
    norm = torch.sqrt((x * x).sum(dim=1, keepdim=True) + 1e-24)
    x = drop(x / norm.clamp_min(1e-12), len(layers))
    return linear(x, params["linear.weight"], params["linear.bias"],
                  precision)
