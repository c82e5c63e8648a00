"""gnn_tpu_torch: the PyTorch / CUDA port of `gnn_tpu` for one NVIDIA
H100.

The layout mirrors `gnn_tpu` (``ops/``, ``sampling/``, ``models/``,
``train/``, ``cli.py``), so each module has a counterpart there. The
port imports nothing of `gnn_tpu` and no JAX: numpy-only host modules
(``native/``, ``data/``, ``utils/``, ``placement/``) are copies. Each
Pallas kernel of the JAX package becomes a hand-written Hopper kernel
under ``csrc/``, built at first use. Data parallelism runs one process
per rank over ``torch.distributed`` (``parallel/``).
"""
