"""The port's models (gnn_tpu_torch.models.gnn) with weights copied from
flax by ``params_from_flax`` give the same outputs as gnn_tpu's flax
models, layer by layer and end to end, dropout off. Tolerance: rtol =
atol = 2e-5 (float32 matmuls and reductions in another order; the
per-row LayerNorm divides by a standard deviation that can be small)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gnn_tpu.models import gat as jgat
from gnn_tpu.models import gnn as jgnn
from gnn_tpu.ops import sparse as jsp
from gnn_tpu_torch.models import gat as tgat
from gnn_tpu_torch.models import gnn as tgnn
from gnn_tpu_torch.ops import sparse as tsp
from gnn_tpu_torch.weights import params_from_flax

TOL = dict(rtol=2e-5, atol=2e-5)


def _batch(rng, orders, widths):
    """Per-layer COO adjs + sampled nodes for level sizes ``widths``
    (bottom-up), packed by both packages."""
    jadjs, tadjs, sampled = [], [], []
    for l, o in enumerate(orders):
        nc, nr = widths[l], widths[l + 1]
        if o == 0:
            jadjs.append(None)
            tadjs.append(None)
            sampled.append(np.zeros(nr, np.int32))
            continue
        m = sp.random(nr, nc, density=0.1, format="csr", random_state=rng,
                      dtype=np.float32).tocoo()
        args = (m.row.astype(np.int32), m.col.astype(np.int32),
                m.data, nr, nc, nr, nc)
        jadjs.append(jax.tree_util.tree_map(jnp.asarray,
                                            jsp.pack_coo(*args)))
        tadjs.append(tsp.to_device(tsp.pack_coo(*args), "cpu"))
        sampled.append(rng.choice(nc, nr, replace=False).astype(np.int32))
    return jadjs, tadjs, sampled


def _jax_layer(model, h, order, lp, x, adj, sampled):
    """One flax encoder layer applied on its own."""
    if model == "gat":
        if order == 0:   # flax: elu(Dense(gcs_i)(x))
            return jax.nn.elu(x @ lp["params"]["kernel"]
                              + lp["params"]["bias"])
        return jgat.GATConv(n_out=h, impl="edge").apply(lp, x, adj, sampled)
    conv = {"graphsage": jgnn.SageConv, "gcn": jgnn.GraphConv,
            "gin": jgnn.GINConv}[model](n_out=h, order=order)
    return conv.apply(lp, x, adj, sampled)


@pytest.mark.parametrize("orders", [(1, 1), (1, 0, 1)])
@pytest.mark.parametrize("model", ["graphsage", "gcn", "gin", "gat"])
def test_model_matches_flax(model, orders):
    rng = np.random.RandomState(0)
    f, h, c = 20, 16, 5
    widths = [96] + [64 if o == 1 else 0 for o in orders]
    for l in range(1, len(widths)):
        if widths[l] == 0:
            widths[l] = widths[l - 1]
    widths[-1] = 32
    if orders[-1] == 0:
        widths[-1] = widths[-2]
    jadjs, tadjs, sampled = _batch(rng, orders, widths)
    x = rng.randn(widths[0], f).astype(np.float32)

    if model == "gat":
        # COO layers take GAT's per-edge route (the tile route needs K2)
        jnet = jgnn.GNN(encoder=jgat.GATEncoder(
            nhid=h, orders=orders, dropout=0.0, impl="edge"),
            num_classes=c, dropout=0.0)
        tnet = tgnn.GNN(tgat.GATEncoder(f, h, orders, 0.0, impl="edge"), c,
                        0.0)
    else:
        jnet = jgnn.build_model(model, h, orders, c, dropout=0.0)
        tnet = tgnn.build_model(model, h, orders, c, n_feats=f,
                                dropout=0.0)
    params = jnet.init(jax.random.PRNGKey(1), jnp.asarray(x), jadjs,
                       [jnp.asarray(s) for s in sampled])
    params = jax.tree_util.tree_map(np.asarray, params)
    missing = tnet.load_state_dict(params_from_flax(params), strict=True)
    assert not missing.missing_keys and not missing.unexpected_keys
    tnet.eval()

    # layer by layer, the same input into both
    xl = x
    tsam = [torch.from_numpy(s) for s in sampled]
    for i, o in enumerate(orders):
        lp = {"params": params["params"]["encoder"][f"gcs_{i}"]}
        jy = _jax_layer(model, h, o, lp, jnp.asarray(xl), jadjs[i],
                        jnp.asarray(sampled[i]))
        with torch.no_grad():
            ty = tnet.encoder.layers[i](torch.from_numpy(xl), tadjs[i],
                                        tsam[i])
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL,
                                   err_msg=f"layer {i}")
        xl = np.asarray(jy)

    jout = jnet.apply(params, jnp.asarray(x), jadjs,
                      [jnp.asarray(s) for s in sampled])
    with torch.no_grad():
        tout = tnet(torch.from_numpy(x), tadjs, tsam)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


def test_init_matches_flax_statistics():
    """Dense kernels initialise lecun-normal (truncated normal, variance
    1/fan_in), biases zero, LayerNorm scale 1 / offset 0."""
    net = tgnn.build_model("graphsage", 256, (1, 1), 7, n_feats=512,
                           seed=3)
    w = net.encoder.layers[0].linearW.weight.detach().numpy()
    assert w.shape == (256, 512)
    assert abs(w.var() * 512 - 1.0) < 0.05
    assert np.abs(w).max() <= 2.0 / np.sqrt(512) / 0.87962566103423978 + 1e-6
    assert np.all(net.encoder.layers[0].linearW.bias.detach().numpy() == 0)
    assert np.all(net.encoder.layers[1].scale.detach().numpy() == 1)
    other = tgnn.build_model("graphsage", 256, (1, 1), 7, n_feats=512,
                             seed=4)
    assert not torch.equal(other.linear.weight, net.linear.weight)
