"""The slice as a whole: the port's Trainer against gnn_tpu's Trainer on
the same configuration — ``small_graph``, orders (1, 1), nhid 32,
samp_num 128, batch 64, hot_k 256, a float32 hot block, the edge-stream
cold path on (the JAX side runs the Pallas kernel in interpret mode, the
port its plain version on the CPU), dropout 0, and the same initial
parameters (copied from flax). Each epoch is one step on a 64-node
target set, so each epoch's loss is one step's loss; the val pass after
the last step is compared too. GraphSAGE runs a constant lr; GAT (hot-
block attention, the edge-stream attention on its cold residual) a
linear warmup over 3 of the 4 steps. The same comparison runs GraphSAGE
on the blocked format and GAT on the pattern transport (the tile route
on both layers), with no hot block; GraphSAGE on the hot format (the
host-packed cold COO and plumbing, the hot blocks bound on the device);
and GraphSAGE and GAT on the resident path with the subgraph sampler;
and GraphSAGE with locality sampling on both samplers.
Tolerance: rtol = 1e-4, atol = 1e-5 — float32 sums in another order,
carried through four Adam steps."""
import numpy as np
import jax
import pytest
import torch

from gnn_tpu.models.gnn import build_model as jbuild
from gnn_tpu.ops.hotdense import HotSpec as JHotSpec, build_hot_dense
from gnn_tpu.ops.residentgraph import build_resident_graph as jbuild_rg
from gnn_tpu.parallel.mesh import make_mesh
from gnn_tpu.placement.engine import compute_sample_prob
from gnn_tpu.sampling.ladies import SamplerConfig as JCfg
from gnn_tpu.sampling.pipeline import BatchPipeline as JPipe
from gnn_tpu.train.trainer import Trainer as JTrainer
from gnn_tpu.utils.normalize import build_laplacian
from gnn_tpu_torch.models.gnn import build_model as tbuild
from gnn_tpu_torch.ops.hotdense import HotSpec as THotSpec
from gnn_tpu_torch.ops.hotdense import build_hot_dense as tbuild_hd
from gnn_tpu_torch.ops.residentgraph import build_resident_graph as \
    tbuild_rg
from gnn_tpu_torch.sampling.ladies import SamplerConfig as TCfg
from gnn_tpu_torch.sampling.pipeline import BatchPipeline as TPipe
from gnn_tpu_torch.train.trainer import Trainer as TTrainer
from gnn_tpu_torch.weights import params_from_flax

STEPS = 4
# the fixed locality factor of the skewed cases (the tuner stays off)
SKEW_FACTOR = 4.0


def locality_skews(g, lap):
    """Each package's per-rank skew sets for one device on ``g``: the
    greedy placement of 20% of the nodes, pushed through ``A + I``."""
    import scipy.sparse as sp

    from gnn_tpu.placement import engine as jeng
    from gnn_tpu_torch.placement import engine as teng
    n = g.adj_full.shape[0]
    out = []
    for eng in (jeng, teng):
        pl = eng.create_placement(lap, g.train_nodes, per_dev=n // 5,
                                  num_devs=1, num_conv_layers=2)
        out.append(eng.get_per_rank_skewed_nodes(g.adj_full + sp.eye(n),
                                                 pl, (1, 1)))
    return out


def build_pair(g, model, lr, lr_warmup, adj_format="resident",
               sampler="ladies", skew=False):
    """The JAX package's Trainer and a factory of the port's Trainers on
    the module docstring's configuration, with the same initial
    parameters; ``skew`` samples with each package's locality skew at
    ``SKEW_FACTOR``. Returns ``(jax trainer, make_torch_trainer,
    targets)``; the caller closes every pipeline."""
    orders, c = (1, 1), g.num_classes
    lap = build_laplacian(g.adj_full, model)
    kw = dict(batch_size=64, samp_num=128, orders=orders,
              num_nodes=lap.shape[0], num_classes=c, adj_format=adj_format,
              sampler=sampler)
    targets = g.train_nodes[:64]
    jkw, tkw, jrg, trg, jhot, thot = {}, {}, None, None, None, None
    if adj_format in ("hot", "resident"):
        prob = compute_sample_prob(lap, g.train_nodes, sum(orders))
        jspec = JHotSpec.from_sample_prob(prob, 256)
        d, dt = build_hot_dense(lap, jspec, np.float32)
        tspec = THotSpec.from_sample_prob(prob, 256)
        td, tdt = tbuild_hd(lap, tspec, torch.float32, "cpu")
        jkw, tkw = dict(hot_spec=jspec), dict(hot_spec=tspec)
        if adj_format == "resident":
            kw.update(resident_val_free=True, resident_stream_tiles=True)
            jrg, trg = jbuild_rg(lap, jspec, d, dt), tbuild_rg(lap, tspec,
                                                               td, tdt)
        else:
            jhot, thot = (d, dt), (td, tdt)
    jskew = tskew = None
    if skew:
        kw.update(scale_factor=SKEW_FACTOR)
        jskew, tskew = locality_skews(g, lap)

    jpipe = JPipe(JCfg(**jkw, **kw), lap, g.labels,
                  world_size=1, pool_num=2, per_rank_skew=jskew, seed=3)
    jtr = JTrainer(jbuild(model, 32, orders, c, dropout=0.0), jpipe,
                   g.feats, mesh=make_mesh(1), lr=lr,
                   sigmoid_loss=True, seed=3, resident_graph=jrg,
                   hot_dense=jhot, lr_warmup=lr_warmup)
    jtr._init_params(jtr._peek_batch(targets))
    init = params_from_flax(jax.tree_util.tree_map(np.asarray, jtr.params))

    def make_torch_trainer():
        tpipe = TPipe(TCfg(**tkw, **kw), lap, g.labels, pool_num=2,
                      per_rank_skew=tskew, seed=3)
        tnet = tbuild(model, 32, orders, c, n_feats=g.feats.shape[1],
                      dropout=0.0)
        tnet.load_state_dict(init)
        return TTrainer(tnet, tpipe, g.feats, lr=lr,
                        sigmoid_loss=True, seed=3, resident_graph=trg,
                        hot_dense=thot, lr_warmup=lr_warmup, device="cpu")
    return jtr, make_torch_trainer, targets


def _steps_match_jax(g, model, lr, lr_warmup, adj_format="resident",
                     sampler="ladies", skew=False):
    jtr, make_torch_trainer, targets = build_pair(
        g, model, lr, lr_warmup, adj_format, sampler, skew)
    ttr = make_torch_trainer()
    try:
        jl = [jtr.train_epoch(targets, epoch=e).train_loss
              for e in range(STEPS)]
        tl = [ttr.train_epoch(targets, epoch=e).train_loss
              for e in range(STEPS)]
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-5)
        assert tl[-1] < tl[0]
        jf1, jvl = jtr.evaluate(g.valid_nodes, 128, "val")
        tf1, tvl = ttr.evaluate(g.valid_nodes, 128, "val")
        assert tvl == pytest.approx(jvl, rel=1e-4, abs=1e-5)
        assert tf1 == pytest.approx(jf1, abs=1e-6)
    finally:
        ttr.pipeline.close()
        jtr.close()


def test_training_steps_match_jax(small_graph):
    _steps_match_jax(small_graph, "graphsage", lr=0.01, lr_warmup=0)


def test_gat_training_steps_match_jax(small_graph):
    """GAT on the resident hot-block path with the cold residual through
    the edge-stream attention (Pallas in interpret mode vs the port's
    plain versions), and a linear lr warmup: the port's warmup schedule
    against optax's ``linear_schedule``."""
    _steps_match_jax(small_graph, "gat", lr=0.01, lr_warmup=3)


def test_blocked_training_steps_match_jax(small_graph):
    """GraphSAGE on ``adj_format="blocked"``: the port's blocked plain
    version (K2's counterpart on the CPU) against the JAX package's
    blocked aggregation, forward and over the packed transposed tiles."""
    _steps_match_jax(small_graph, "graphsage", lr=0.01, lr_warmup=0,
                     adj_format="blocked")


def test_gat_pattern_training_steps_match_jax(small_graph):
    """GAT on the pattern transport: both layers take the tile route
    (K5 + K2 plain versions on the port's side), with the lr warmup."""
    _steps_match_jax(small_graph, "gat", lr=0.01, lr_warmup=3,
                     adj_format="pattern")


def test_hot_format_training_steps_match_jax(small_graph):
    """GraphSAGE on ``adj_format="hot"``: host-packed layers, the hot
    blocks bound on the device, the cold residual through the shipped COO
    (forward) and its col-sorted copy (backward)."""
    _steps_match_jax(small_graph, "graphsage", lr=0.01, lr_warmup=0,
                     adj_format="hot")


def test_subgraph_training_steps_match_jax(small_graph):
    """GraphSAGE on the resident path with the subgraph sampler: the
    square deeper layer through the edge-stream tiles (K1's plain version
    here, the Pallas kernel in interpret mode on the JAX side)."""
    _steps_match_jax(small_graph, "graphsage", lr=0.01, lr_warmup=0,
                     sampler="subgraph")


def test_gat_subgraph_training_steps_match_jax(small_graph):
    """GAT on the resident path with the subgraph sampler (the
    edge-stream attention on square layers), with the lr warmup."""
    _steps_match_jax(small_graph, "gat", lr=0.01, lr_warmup=3,
                     sampler="subgraph")


@pytest.mark.parametrize("sampler", ["ladies", "subgraph"])
def test_locality_training_steps_match_jax(small_graph, sampler):
    """GraphSAGE on the resident path with locality sampling: both
    packages skew toward their own placement buffer's nodes at a fixed
    factor of 4 (the tuner off, so no factor depends on timing)."""
    _steps_match_jax(small_graph, "graphsage", lr=0.01, lr_warmup=0,
                     sampler=sampler, skew=True)
