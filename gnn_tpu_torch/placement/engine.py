"""(A copy of `gnn_tpu.placement.engine`, so the port imports nothing of the JAX
package.) Feature-placement engine: decides which node features live in each
device's HBM buffer vs. host RAM.

Re-implements the reference's placement algorithms
(reference `preprocess.py:260-423`) — the ICS'22 paper's core
contribution — as vectorized numpy:

* **Access-probability model** (`preprocess.py:343-345`): ``sample_prob =
  1⃗ · lap[train, :] · lap^(L-1)`` — the expected LADIES sampling mass
  reaching each node after L hops from the training set.

* **"Our" greedy distribution** (`preprocess.py:354-384`): the hottest
  ``per_dev`` nodes are replicated on every device; then the next-hottest
  candidates each *replace* one replicated tail slot on exactly one device
  (chosen round-robin over the devices with least accumulated probability),
  gated by ``prob[cand] >= alpha * prob[replaced]``. The gate is monotone
  (candidate probs descend while replaced probs ascend), so the reference's
  per-iteration break becomes a binary-searched cutoff here.

* **PaGraph** baseline (`preprocess.py:267-309`): Algorithm 1 of the
  PaGraph paper — train nodes in blocks, L-hop expansion, greedy
  assignment maximizing ``|intersect| * (N - |set|) / PV``.

* **Naive / random** baselines (`preprocess.py:328-341`): contiguous or
  shuffled equal slices.

* **Skewed sampling sets** (`preprocess.py:414-423`) for locality-aware
  sampling.

Outputs use the reference's map structure: per-rank ``device_id_of_nodes``
(node -> owning device, or -1 for host) and ``idx_of_nodes_on_device``
(node -> buffer slot), plus per-device buffered node-id lists. Results are
cached on disk keyed by the same tuple the reference uses
(`preprocess.py:317`).
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass
class Placement:
    """Placement maps for ``num_devs`` devices over ``n`` nodes."""

    device_id_of_nodes: np.ndarray      # int32 [num_devs, N]; -1 = host
    idx_of_nodes_on_device: np.ndarray  # int64 [num_devs, N] buffer slot
    buffers: List[np.ndarray]           # per-device buffered node ids
    train_nodes_per_dev: Optional[List[np.ndarray]] = None  # pagraph only

    @property
    def num_devs(self) -> int:
        return self.device_id_of_nodes.shape[0]


def compute_sample_prob(lap: sp.csr_matrix, train_nodes: np.ndarray,
                        num_conv_layers: int) -> np.ndarray:
    """`preprocess.py:343-345`: ones over train rows pushed through the
    laplacian L times."""
    v = np.ones(len(train_nodes), dtype=np.float64) * lap[train_nodes, :]
    v = np.asarray(v).ravel()
    for _ in range(num_conv_layers - 1):
        v = v * lap
        v = np.asarray(v).ravel()
    return v


def greedy_placement(sample_prob: np.ndarray, per_dev: int, num_devs: int,
                     alpha: float = 1.0) -> Placement:
    """The paper's placement algorithm (`preprocess.py:354-384`)."""
    n = len(sample_prob)
    order = np.argsort(-sample_prob, kind="stable")
    total = min(per_dev * num_devs, n)
    buffered = order[:total]

    device_id = np.full((num_devs, n), -1, np.int32)
    slot = np.tile(np.arange(n, dtype=np.int64), (num_devs, 1))
    top = buffered[:per_dev]
    for d in range(num_devs):
        device_id[d, top] = d
    slot[:, top] = np.arange(len(top))
    buffers = [top.copy() for _ in range(num_devs)]

    if num_devs == 1 or total <= per_dev:
        return Placement(device_id, slot, buffers)

    tail = buffered[per_dev:]
    k = num_devs - 1
    n_cand = len(tail)
    # replaced slot for candidate i: per_dev-1 - i//k (`preprocess.py:371`)
    repl_slot = per_dev - 1 - np.arange(n_cand) // k
    usable = repl_slot >= 0
    # monotone alpha gate -> cutoff (`preprocess.py:374`)
    cand_p = sample_prob[tail]
    repl_p = np.where(usable, sample_prob[buffered[np.maximum(repl_slot, 0)]],
                      np.inf)
    ok = cand_p >= alpha * repl_p
    cutoff = int(np.argmin(ok)) if not ok.all() else n_cand

    # simulate the round-robin device assignment; device_order refreshes
    # every k candidates (`preprocess.py:367-368`)
    p_accum = np.zeros(num_devs)
    chosen_dev = np.empty(cutoff, np.int32)
    routed_dev = np.empty(cutoff, np.int32)  # where others read `replaced`
    for start in range(0, cutoff, k):
        dev_order = np.argsort(p_accum, kind="stable")
        end = min(start + k, cutoff)
        m = end - start
        chosen = dev_order[:m]
        chosen_dev[start:end] = chosen
        routed_dev[start:end] = dev_order[-1]
        p_accum[chosen] += cand_p[start:end]

    cands = tail[:cutoff]
    rslots = repl_slot[:cutoff]
    replaced_nodes = buffered[rslots]
    # every rank maps candidate -> its chosen device + slot
    for d in range(num_devs):
        device_id[d, cands] = chosen_dev
        slot[d, cands] = rslots
    # the chosen device no longer holds `replaced`; it reads it from the
    # device with max accumulated probability (`preprocess.py:380`)
    device_id[chosen_dev, replaced_nodes] = routed_dev
    # install candidates into buffers
    for d in range(num_devs):
        mine = chosen_dev == d
        buffers[d][rslots[mine]] = cands[mine]

    return Placement(device_id, slot, buffers)


def naive_placement(n: int, per_dev: int, num_devs: int,
                    random: bool = False,
                    seed: int = 0) -> Placement:
    """Contiguous (or shuffled) equal slices (`preprocess.py:328-341`).
    All ranks share one map."""
    ids = np.arange(n, dtype=np.int64)
    if random:
        ids = np.random.default_rng(seed).permutation(n)
    device_id = np.full(n, -1, np.int32)
    slot = np.arange(n, dtype=np.int64)
    buffers = []
    for d in range(num_devs):
        mine = ids[d * per_dev:(d + 1) * per_dev]
        buffers.append(mine.copy())
        device_id[mine] = d
        slot[mine] = np.arange(len(mine))
    return Placement(np.tile(device_id, (num_devs, 1)),
                     np.tile(slot, (num_devs, 1)), buffers)


def _hop_expand(lap: sp.csr_matrix, nodes: np.ndarray,
                hops: int) -> np.ndarray:
    """L-hop neighborhood incl. the seed set (`preprocess.py:260-265`).

    Frontier-limited: each hop gathers only the CSR spans of the nodes
    NEW in the previous hop — O(sum deg(frontier)) instead of the dense
    O(N)-vector SpVM per hop per block the reference does (at PaGraph's
    20 blocks x L hops that was O(20 L E) total, quadratic pain at
    MAG240M scale)."""
    indptr, indices = lap.indptr, lap.indices
    cur = np.unique(np.asarray(nodes, np.int64))
    frontier = cur
    for _ in range(hops):
        if len(frontier) == 0:
            break
        lo = indptr[frontier]
        deg = indptr[frontier + 1] - lo
        nz = deg > 0            # zero-degree rows would duplicate starts
        lo, deg = lo[nz], deg[nz]
        total = int(deg.sum())
        if total == 0:
            break
        # vectorized span gather: flat[i] = lo[row_of_i] + offset_within
        starts = np.cumsum(deg) - deg
        seg = np.zeros(total, np.int64)
        seg[starts[1:]] = 1
        row = np.cumsum(seg)
        flat = lo[row] + (np.arange(total) - starts[row])
        neigh = np.unique(indices[flat])
        frontier = neigh[~np.isin(neigh, cur, assume_unique=False)]
        cur = np.union1d(cur, frontier)
    return cur


def pagraph_placement(train_nodes: np.ndarray, lap: sp.csr_matrix,
                      sample_prob: np.ndarray, num_devs: int,
                      num_conv_layers: int, per_dev: int,
                      nblocks: int = 20) -> Placement:
    """PaGraph Algorithm 1 (`preprocess.py:267-309`).

    Note an intentional divergence: the reference's per-device buffer
    extraction (`preprocess.py:305`) runs ``list.index`` over subset
    probabilities and then uses those *positions within the subset* as
    global node ids — an id/index confusion that buffers the wrong nodes
    whenever a device's node set is not a prefix of ``range(N)``. We
    implement the evidently intended semantics: buffer the ``per_dev``
    nodes of the device's set with the highest ``sample_prob``.
    """
    n = lap.shape[1]
    block_size = max(len(train_nodes) // nblocks, 1)
    nodes_sets: List[np.ndarray] = []
    train_sets: List[np.ndarray] = []
    pv = np.ones(num_devs)

    for d in range(num_devs):
        block = train_nodes[d * block_size:(d + 1) * block_size]
        s = _hop_expand(lap, block, num_conv_layers)
        pv[d] += len(s)
        nodes_sets.append(s)
        train_sets.append(np.asarray(block))

    for j in range(num_devs * block_size, len(train_nodes), block_size):
        block = train_nodes[j: j + block_size]
        s = _hop_expand(lap, block, num_conv_layers)
        scores = np.array([
            len(np.intersect1d(nodes_sets[d], s, assume_unique=True))
            * (lap.shape[0] - len(nodes_sets[d])) / pv[d]
            for d in range(num_devs)])
        best = int(np.argmax(np.abs(scores)))
        pv[best] += len(s)
        nodes_sets[best] = np.union1d(nodes_sets[best], s)
        train_sets[best] = np.concatenate([train_sets[best], block])

    device_id = np.full((num_devs, n), -1, np.int32)
    slot = np.tile(np.arange(n, dtype=np.int64), (num_devs, 1))
    buffers = []
    for d in range(num_devs):
        cand = nodes_sets[d]
        take = min(per_dev, len(cand))
        hot = cand[np.argsort(-sample_prob[cand], kind="stable")[:take]]
        buffers.append(hot)
        device_id[d, hot] = d
        slot[d, hot] = np.arange(len(hot))
    return Placement(device_id, slot, buffers, train_sets)


def get_skewed_sampled_nodes(adj_with_self: sp.csr_matrix,
                             buffers: Sequence[np.ndarray],
                             orders: Sequence[int],
                             top_k: int = 8192) -> List[np.ndarray]:
    """Per-layer skew sets for locality-aware sampling
    (`preprocess.py:414-423`): layer 0 = all buffered nodes; deeper layers
    = top-k nodes of the buffered indicator pushed through A^i."""
    sets = [np.unique(np.concatenate([np.asarray(b) for b in buffers]))]
    v = np.zeros(adj_with_self.shape[1])
    v[sets[0]] = 1.0
    for _ in range(1, len(list(orders))):
        v = np.asarray(v * adj_with_self).ravel()
        sets.append(np.argsort(-v, kind="stable")[:top_k])
    return sets


def get_per_rank_skewed_nodes(adj_with_self: sp.csr_matrix,
                              placement: Placement,
                              orders: Sequence[int],
                              top_k: int = 8192) -> List[List[np.ndarray]]:
    """Per-RANK per-layer skew sets: each rank skews toward the nodes
    resident in ITS OWN buffer (`sampler.py:23-25,119-121` uses
    ``device_id_of_nodes == device`` — the union-of-all-buffers variant
    would skew every rank toward the same global set and defeat the
    point of per-device placement). Deeper layers push the rank's own
    resident indicator through A^i, mirroring `preprocess.py:417-422`."""
    out: List[List[np.ndarray]] = []
    n_layers = len(list(orders))
    for d in range(placement.num_devs):
        own = np.flatnonzero(placement.device_id_of_nodes[d] == d)
        sets = [own.astype(np.int64)]
        v = np.zeros(adj_with_self.shape[1])
        v[own] = 1.0
        for _ in range(1, n_layers):
            v = np.asarray(v * adj_with_self).ravel()
            sets.append(np.argsort(-v, kind="stable")[:top_k])
        out.append(sets)
    return out


def create_placement(
    lap: sp.csr_matrix,
    train_nodes: np.ndarray,
    per_dev: int,
    num_devs: int,
    num_conv_layers: int,
    alpha: float = 1.0,
    strategy: str = "greedy",       # greedy | pagraph | naive | random
    cache_dir: Optional[str] = None,
    dataset: str = "graph",
) -> Placement:
    """Compute (or load cached) placement maps — the orchestration of
    `preprocess.py:311-395` with an npz cache keyed the same way."""
    fname = None
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        fname = os.path.join(
            cache_dir,
            f"{dataset}.({num_devs}).({per_dev}).({alpha})."
            f"({num_conv_layers}).({strategy}).buf.npz")
        if os.path.exists(fname):
            z = np.load(fname, allow_pickle=True)
            tn = None
            if "train_sets" in z.files:
                tn = [np.asarray(t, np.int64) for t in z["train_sets"]]
            bufs = [np.asarray(b, np.int64) for b in z["buffers"]]
            return Placement(z["device_id"], z["slot"], bufs, tn)

    if strategy in ("naive", "random"):
        p = naive_placement(lap.shape[1], per_dev, num_devs,
                            random=(strategy == "random"))
    else:
        prob = compute_sample_prob(lap, train_nodes, num_conv_layers)
        if strategy == "pagraph":
            p = pagraph_placement(train_nodes, lap, prob, num_devs,
                                  num_conv_layers, per_dev)
        elif strategy == "greedy":
            p = greedy_placement(prob, per_dev, num_devs, alpha)
        else:
            raise ValueError(f"unknown placement strategy {strategy!r}")

    if fname is not None:
        extra = {}
        if p.train_nodes_per_dev is not None:
            extra["train_sets"] = np.asarray(p.train_nodes_per_dev,
                                             dtype=object)
        np.savez(fname, device_id=p.device_id_of_nodes,
                 slot=p.idx_of_nodes_on_device,
                 buffers=np.asarray(p.buffers, dtype=object), **extra)
    return p
