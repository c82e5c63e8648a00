"""The plain reference the benchmark holds the port's training steps
against: NumPy for the graph (Laplacian, sampling probabilities, the hot
set, each sampled layer's edges and debias weights, all worked out
again from the raw adjacency) and plain PyTorch for the model, loss,
clip and Adam (``model_<name>.py``, one file a model). It imports
neither ``jax`` nor ``gnn_tpu`` nor anything of ``gnn_tpu_torch``."""
