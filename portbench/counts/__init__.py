"""The benchmark's frozen yardstick: the card's published peaks, the
bytes and operations of the port's kernels (copied from ``chip_smoke.py``
and frozen here) and the operations a training step requires
(``model_<name>.py``, one file a model, found by the configuration's
``model``)."""
