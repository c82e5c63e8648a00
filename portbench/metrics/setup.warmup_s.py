"""Seconds of set-up from the first step to the window: the checked
steps and the warm-up epochs, kernel loads and CUDA-graph captures
included; the harness's span."""


def read(rec):
    return rec["spans"]["setup.warmup"]
