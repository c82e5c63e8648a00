"""Forward operations of a step of the published GAT (arXiv:1710.10903),
all float32: per layer ``z = W x`` on the columns, the heads' ``el`` and
``er`` on the rows and the columns, the weighted sum of ``z`` over the
layer's true edges and each row's self edge (``2 * (nnz + r) * width``;
the few operations a score takes per head are left out), and the second
layer's residual projection on the rows. The heads' mean at the output
is left out too."""
from __future__ import annotations


def _widths(config: dict) -> list:
    heads, last = config["heads"], len(config["orders"]) - 1
    return [h * (config["classes"] if i == last else config["nhid"] // h)
            for i, h in enumerate(heads)]


def forward_flops(config: dict, layers: list, batch_rows: int) -> dict:
    flops = 0.0
    f_in = config["n_feats"]
    last = len(config["orders"]) - 1
    for i, (n, lay) in enumerate(zip(_widths(config), layers)):
        r, c = lay["r"], lay["c"]
        flops += 2 * c * f_in * n
        flops += 2 * (r + c) * n
        flops += 2.0 * (lay["nnz"] + r) * n
        if i == 1 and i < last:
            flops += 2 * r * f_in * n
        f_in = n
    return {"float32": flops}


def layer_widths(config: dict) -> list:
    """The width of the rows each layer reads."""
    return [config["n_feats"]] + _widths(config)[:-1]
