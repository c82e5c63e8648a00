"""The port's CLI (gnn_tpu_torch.cli): the JAX package's flags and
defaults plus ``--device``, CPU runs end to end on every ported format,
the JAX package's format rules, the single-device extras (locality
sampling, resume, op timing, profiling), the launch of the ``data x
part`` grid, grouped dispatch (``--steps_per_dispatch``) and the
``NotImplementedError`` of its combinations not ported."""
import json
import math
import os

import pytest
import torch

from gnn_tpu import cli as jcli
from gnn_tpu_torch import cli as tcli
from gnn_tpu_torch.train.checkpoint import load_checkpoint

TINY = ["--dataset", "synthetic:nodes=1200,deg=10,feats=16,classes=5",
        "--nhid", "16", "--orders", "1,1", "--samp_num", "128",
        "--batch_size", "64", "--epoch_num", "1", "--hot_k", "256",
        "--pool_num", "2"]


def test_parser_matches_jax_plus_device():
    """The JAX CLI's flags and defaults, plus ``--device`` and the
    collectives' ``--dist_backend``, and the JAX CLI's choices, plus the
    port's own model ``gatv1`` (the published GAT, which the JAX package
    does not have)."""
    j = vars(jcli.build_parser().parse_args([]))
    t = vars(tcli.build_parser().parse_args([]))
    assert t.pop("device") == "cuda"
    assert t.pop("dist_backend") == "auto"
    assert t == j
    jp, tp = jcli.build_parser(), tcli.build_parser()
    jflags = {o for a in jp._actions for o in a.option_strings}
    tflags = {o for a in tp._actions for o in a.option_strings}
    assert tflags - jflags == {"--device", "--dist_backend"}
    assert jflags <= tflags
    for a in jp._actions:
        if a.choices:
            (b,) = [x for x in tp._actions if x.dest == a.dest
                    and x.option_strings == a.option_strings]
            extra = ["gatv1"] if a.dest == "model" else []
            assert list(b.choices) == list(a.choices) + extra, a.dest


@pytest.mark.parametrize("model,lr,warmup", [
    ("graphsage", None, -1), ("gat", None, -1), ("gin", 0.05, 7)])
def test_training_defaults_match_jax(model, lr, warmup):
    argv = ["--model", model, "--lr_warmup", str(warmup)]
    if lr is not None:
        argv += ["--lr", str(lr)]
    ja, ta = jcli.build_parser().parse_args(argv), \
        tcli.build_parser().parse_args(argv)
    assert tcli.resolve_training_defaults(ta, 50) == \
        jcli.resolve_training_defaults(ja, 50)
    assert ta.lr == ja.lr


@pytest.mark.parametrize("steps,warmup", [(50, 50), (1000, 300)])
def test_gatv1_training_defaults(steps, warmup):
    """gatv1 (not in the JAX CLI): the published lr 0.005 with gat's
    automatic warm-up, which its benchmark configuration states too."""
    a = tcli.build_parser().parse_args(["--model", "gatv1"])
    assert tcli.resolve_training_defaults(a, steps) == warmup
    assert a.lr == 0.005


@pytest.mark.parametrize("extra", [
    [], ["--resident_stream", "on"], ["--adj_format", "coo"]])
def test_main_trains_one_epoch_on_cpu(tmp_path, extra):
    save = str(tmp_path / "save")
    assert tcli.main(TINY + ["--device", "cpu", "--test", "--save_dir",
                             save] + extra) == 0
    recs = [json.loads(l) for l in open(os.path.join(save,
                                                     "metrics.jsonl"))]
    ep = recs[0]
    assert len(ep["step_losses"]) == math.ceil(720 / 64)
    assert all(math.isfinite(v) for v in ep["step_losses"])
    assert 0.0 <= recs[-1]["test_f1"] <= 1.0
    params, step, opt_state, best_val, n_updates = load_checkpoint(
        save, "latest")
    assert step == 1 and opt_state["state"]
    assert n_updates == len(ep["step_losses"])
    assert params["linear.weight"].shape == (5, 32)
    assert best_val == pytest.approx(ep["valid_f1"])


def test_gat_trains_one_epoch_on_cpu(tmp_path):
    """``--model gat`` on the resident path (hot-block attention; the cold
    residual through the plain versions of the edge-stream attention
    kernels): finite losses, lr warmup on by default."""
    save = str(tmp_path / "save")
    assert tcli.main(TINY + ["--model", "gat", "--device", "cpu", "--test",
                             "--save_dir", save]) == 0
    recs = [json.loads(l) for l in open(os.path.join(save,
                                                     "metrics.jsonl"))]
    ep = recs[0]
    assert len(ep["step_losses"]) == math.ceil(720 / 64)
    assert all(math.isfinite(v) for v in ep["step_losses"])
    assert 0.0 <= recs[-1]["test_f1"] <= 1.0
    params, _, _, _, _ = load_checkpoint(save, "latest")
    assert params["encoder.layers.0.self.weight"].shape == (16, 16)
    assert params["linear.weight"].shape == (5, 16)


@pytest.mark.parametrize("flag", [
    ["--adj_format", "blocked"], ["--model", "gat", "--adj_format", "pattern"],
    ["--model", "gat", "--adj_format", "coo"], ["--adj_format", "hot"],
    ["--sampler", "subgraph"]])
def test_ported_formats_train(tmp_path, flag):
    """The tile-stream formats on the CPU (K2/K5's plain versions), the
    hot format and the subgraph sampler (on the resident path): two
    epochs with finite, falling losses."""
    save = str(tmp_path / "save")
    assert tcli.main(TINY + ["--device", "cpu", "--epoch_num", "2",
                             "--save_dir", save] + flag) == 0
    recs = [json.loads(l) for l in open(os.path.join(save,
                                                     "metrics.jsonl"))]
    losses = recs[0]["step_losses"] + recs[1]["step_losses"]
    assert len(losses) == 2 * math.ceil(720 / 64)
    assert all(math.isfinite(v) for v in losses)
    assert recs[1]["train_loss"] < recs[0]["train_loss"]


def test_format_rules_match_jax(tmp_path, capsys):
    """``--model gat --adj_format hot`` becomes ``pattern``, as in the JAX
    CLI; ``pattern`` without an attention model exits with its
    message."""
    args = tcli.build_parser().parse_args(["--model", "gat", "--adj_format",
                                           "hot"])
    tcli.resolve_adj_format(args)
    assert args.adj_format == "pattern"
    assert "overriding --adj_format hot -> pattern" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="attention-only"):
        tcli.main(TINY + ["--device", "cpu", "--save_dir", str(tmp_path),
                          "--adj_format", "pattern"])


@pytest.mark.parametrize("flag", [
    ["--locality_sampling"], ["--resume"], ["--profile_dir", "prof"],
    ["--op_timing"]])
def test_ported_flags_run(tmp_path, flag):
    """The single-device extras on the CPU, two epochs each: locality
    sampling (the factor logged each epoch), resume (a second call with
    ``--epoch_num 3`` trains epoch 2 only), op timing (finite spmm
    buckets above 0, communication 0.0), a profiler trace of epoch 1."""
    save = str(tmp_path / "save")
    if flag[0] == "--profile_dir":
        flag = ["--profile_dir", str(tmp_path / "prof")]
    argv = TINY + ["--device", "cpu", "--save_dir", save] + flag
    assert tcli.main(argv + ["--epoch_num", "2"]) == 0
    if flag == ["--resume"]:
        assert tcli.main(argv + ["--epoch_num", "3"]) == 0
    recs = [json.loads(l) for l in open(os.path.join(save,
                                                     "metrics.jsonl"))]
    epochs = [r["epoch"] for r in recs]
    assert epochs == ([0, 1, 2] if flag == ["--resume"] else [0, 1])
    assert all(math.isfinite(v) for r in recs for v in r["step_losses"])
    if flag == ["--locality_sampling"]:
        assert all(r["scale_factor"] >= 1.0 for r in recs)
    if flag == ["--op_timing"]:
        for r in recs:
            assert r["spmm_fwd_s"] > 0 and r["spmm_bwd_s"] > 0
            assert r["communication_s"] == 0.0
    else:
        assert all(math.isnan(r["spmm_fwd_s"]) for r in recs)
    if flag[0] == "--profile_dir":
        assert os.listdir(flag[1]) == ["trace_epoch1.json"]


def test_grouped_dispatch_trains_on_cpu(tmp_path):
    """``--steps_per_dispatch 4`` trains one epoch on the CPU: the 12
    steps of 720 train nodes as three groups of four, every
    step's loss finite and timed, no capture off the card, and the shape
    book written in ``--save_dir``."""
    save = str(tmp_path / "save")
    assert tcli.main(TINY + ["--device", "cpu", "--steps_per_dispatch",
                             "4", "--save_dir", save]) == 0
    (rec,) = [json.loads(l) for l in open(os.path.join(save,
                                                       "metrics.jsonl"))]
    assert len(rec["step_losses"]) == len(rec["step_times"]) == 12
    assert all(math.isfinite(v) for v in rec["step_losses"])
    assert rec["captures"] == 0 and rec["capture_s"] == 0.0
    assert any(f.endswith(".shapebook.json") for f in os.listdir(save))


@pytest.mark.parametrize("flag", [
    ["--adj_format", "hot"], ["--adj_format", "coo"], ["--model", "gat"]],
    ids=["hot", "coo", "gat"])
def test_grouped_dispatch_trains_each_format_on_cpu(tmp_path, flag):
    """``--steps_per_dispatch 2`` on the other combinations that run
    grouped (GraphSAGE on the hot and coo formats, GAT on the resident
    format) trains one epoch on the CPU: the 12 steps as six groups of
    two, every step's loss finite and timed, no capture off the card."""
    save = str(tmp_path / "save")
    assert tcli.main(TINY + ["--device", "cpu", "--steps_per_dispatch",
                             "2", "--save_dir", save] + flag) == 0
    (rec,) = [json.loads(l) for l in open(os.path.join(save,
                                                       "metrics.jsonl"))]
    assert len(rec["step_losses"]) == len(rec["step_times"]) == 12
    assert all(math.isfinite(v) for v in rec["step_losses"])
    assert rec["captures"] == 0 and rec["capture_s"] == 0.0


@pytest.mark.parametrize("flag", [
    ["--steps_per_dispatch", "2", "--model", "gat", "--adj_format",
     "pattern"],
    ["--steps_per_dispatch", "4", "--adj_format", "blocked"],
    ["--steps_per_dispatch", "4", "--n_devices", "2"],
    ["--steps_per_dispatch", "4", "--feature_cache"],
    ["--steps_per_dispatch", "4", "--model", "gat", "--adj_format", "hot"],
    ["--steps_per_dispatch", "4", "--model", "gat", "--adj_format", "coo"]])
def test_unported_flags_raise(tmp_path, monkeypatch, flag):
    """Grouped dispatch with GAT on a format other than resident (``hot``
    turns into ``pattern`` for GAT), the blocked format, more than one
    rank or the feature cache raises before any rank starts."""
    from gnn_tpu_torch.parallel import dist
    monkeypatch.setattr(dist, "spawn_ranks", lambda *a, **k: pytest.fail(
        "a rank was started"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcli.main(TINY + ["--device", "cpu", "--save_dir",
                          str(tmp_path)] + flag)


@pytest.mark.parametrize("flag,world", [
    (["--n_devices", "1", "--resident_parts", "2", "--feature_cache"], 2),
    (["--n_devices", "1", "--resident_parts", "2"], 2),
    (["--n_devices", "2", "--resident_parts", "2"], 4)])
def test_resident_parts_reach_the_grid_launcher(tmp_path, monkeypatch, flag,
                                                world):
    """The part-sharded resident graph (alone, with the cache, under data
    parallelism) parses and starts ``n_devices x resident_parts`` gloo
    ranks of the CLI's rank entry."""
    from gnn_tpu_torch.parallel import dist
    calls = []
    monkeypatch.setattr(dist, "spawn_ranks",
                        lambda n, fn, args, rendezvous_dir: calls.append(
                            (n, fn, args)))
    assert tcli.main(TINY + ["--device", "cpu", "--save_dir",
                             str(tmp_path)] + flag) == 0
    ((n, fn, (args, backend)),) = calls
    assert (n, fn, backend) == (world, tcli._rank_entry, "gloo")
    assert (args.resident_parts, tcli.grid_parts(args)) == (2, 2)
    assert args.feature_cache == ("--feature_cache" in flag)


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(TINY + ["--save_dir", str(tmp_path)])
