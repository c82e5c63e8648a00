"""Forward operations of a GAT step (dot-product attention over the
sampled edges, ``elu(agg + self(x))``), all float32: ``q`` and ``self``
on the output rows, ``k`` and ``v`` on the input rows, the ``q . k``
scores and the weighted sum over the layer's true edges, then the
classifier."""
from __future__ import annotations


def forward_flops(config: dict, layers: list, batch_rows: int) -> dict:
    nhid, feats = config["nhid"], config["n_feats"]
    flops = 0.0
    f_in = feats
    for o, lay in zip(config["orders"], layers):
        r, c = lay["r"], lay["c"]
        if o > 0:
            flops += 2 * (2 * r + 2 * c) * f_in * nhid
            flops += 2 * (2.0 * lay["nnz"] * nhid)
        else:
            flops += 2 * r * f_in * nhid
        f_in = nhid
    flops += 2 * batch_rows * f_in * config["classes"]
    return {"float32": flops}


def layer_widths(config: dict) -> list:
    """The width of the rows each layer reads."""
    return [config["n_feats"]] + [config["nhid"]] * (len(config["orders"])
                                                     - 1)
