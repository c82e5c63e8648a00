"""The benchmark builds its trainer as the port's CLI does: for each tiny
cell, `portbench.program.build` and ``cli.train`` (stopped where it
would start ``Trainer.fit``) give trainers and pipelines configured
alike. `program.build` repeats ``cli.train``'s single-rank construction
(PERF.md lists it for the tracing work); this test fails when the two
part ways."""
import pytest
import torch

import portbench_tiny
from portbench import harness, program

SCALARS = (int, float, bool, str, type(None))


class _Built(Exception):
    def __init__(self, trainer):
        super().__init__("built")
        self.trainer = trainer


def _scalars(obj) -> dict:
    """An object's attributes: scalars, dtypes and devices by value, the
    rest by type."""
    return {k: (v if isinstance(v, SCALARS) else repr(v)
                if isinstance(v, (torch.dtype, torch.device))
                else type(v).__name__)
            for k, v in vars(obj).items()}


def describe(trainer) -> dict:
    """What configures a trainer: its, its pipeline's and its feature
    table's attributes (`_scalars`), the sampler's configuration and
    worker count, the model's parameters by name, shape and dtype (the
    benchmark loads values of its own) and the optimizer's
    hyperparameters."""
    pipe = trainer.pipeline
    src = trainer.feature_source
    return {
        "trainer": _scalars(trainer), "pipeline": _scalars(pipe),
        "sampler_cfg": repr(pipe.cfg),
        "hot_spec": None if pipe.cfg.hot_spec is None
        else repr(pipe.cfg.hot_spec),
        "workers": pipe.pool._max_workers,
        "sampler": getattr(pipe._sampler, "__name__", repr(pipe._sampler)),
        "net": type(trainer.net).__name__,
        "params": {k: (tuple(v.shape), str(v.dtype))
                   for k, v in trainer.net.state_dict().items()},
        "features": (type(src).__name__, _scalars(src)),
        "optimizer": [{k: v for k, v in g.items() if k != "params"}
                      for g in trainer.optimizer.param_groups],
        "agg_state": type(trainer.agg_state).__name__,
    }


@pytest.mark.parametrize("cell_name", list(portbench_tiny.CELLS))
def test_build_configures_the_trainer_as_the_cli_does(cell_name, tmp_path,
                                                      monkeypatch):
    from gnn_tpu_torch import cli
    from gnn_tpu_torch.train.trainer import Trainer
    cell, cfg, tr = portbench_tiny.tiny(cell_name)
    spec = portbench_tiny.spec_of(cell, cfg, tr)
    static = harness.setup_static(spec, "cpu")
    ours, pipe, _, _ = harness.new_trainer(static, spec, 0,
                                           str(tmp_path / "run"))
    try:
        mine = describe(ours)
    finally:
        pipe.close()

    def stop(self, *a, **kw):
        raise _Built(self)
    monkeypatch.setattr(Trainer, "fit", stop)
    args = cli.build_parser().parse_args(
        program.cli_argv(spec, "cpu")
        + ["--save_dir", str(tmp_path / "cli")])
    with pytest.raises(_Built) as built:
        cli.train(args)
    assert mine == describe(built.value.trainer)
