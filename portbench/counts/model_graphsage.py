"""Forward operations of a GraphSAGE step (``concat([B x_self, W (A x)])``
per layer, then the classifier), by precision: the hot block's share of
each aggregation (edges whose two ends lie in the configuration's top
``hot_k`` set) in the configuration's ``hot_dtype``, everything else in
float32."""
from __future__ import annotations


def forward_flops(config: dict, layers: list, batch_rows: int) -> dict:
    nhid, feats = config["nhid"], config["n_feats"]
    orders = config["orders"]
    hot = config["hot_dtype"]
    out = {"float32": 0.0, hot: 0.0}
    f_in = feats
    for o, lay in zip(orders, layers):
        r = lay["r"]
        if o > 0:
            # linearB on the rows' own features, linearW on the aggregate
            out["float32"] += 2 * (2 * r * f_in * nhid)
            out[hot] += 2.0 * lay["nnz_hot"] * f_in
            out["float32"] += 2.0 * (lay["nnz"] - lay["nnz_hot"]) * f_in
        else:
            out["float32"] += 2 * r * f_in * nhid
        f_in = (1 + o) * nhid
    out["float32"] += 2 * batch_rows * f_in * config["classes"]
    return out


def layer_widths(config: dict) -> list:
    """The width of the rows each layer aggregates."""
    out, f_in = [], config["n_feats"]
    for o in config["orders"]:
        out.append(f_in)
        f_in = (1 + o) * config["nhid"]
    return out
