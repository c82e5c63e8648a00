"""Seconds of set-up before the first step: the CLI's set-up (graph
load, Laplacian, placement, hot block, resident graph), the trainer and
the initial parameters; the harness's span around those calls."""


def read(rec):
    return rec["spans"]["setup.prepare"]
