"""The port's CLI (gnn_tpu_torch.cli): the JAX package's flags and
defaults plus ``--device``, CPU runs end to end on every ported format,
the JAX package's format rules, and ``NotImplementedError`` for the flags
whose paths are not ported."""
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
    j = vars(jcli.build_parser().parse_args([]))
    t = vars(tcli.build_parser().parse_args([]))
    assert t.pop("device") == "cuda"
    assert t == j
    jp, tp = jcli.build_parser(), tcli.build_parser()
    jflags = {o for a in jp._actions for o in a.option_strings}
    tflags = {o for a in tp._actions for o in a.option_strings}
    assert tflags - jflags == {"--device"}
    assert jflags <= tflags
    for a in jp._actions:
        if a.choices:
            (b,) = [x for x in tp._actions if x.dest == a.dest
                    and x.option_strings == a.option_strings]
            assert list(b.choices) == list(a.choices), a.dest


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
    params, step, opt_state, best_val = load_checkpoint(save, "latest")
    assert step == 1 and opt_state["state"]
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
    params, _, _, _ = load_checkpoint(save, "latest")
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
    ["--feature_cache"],
    ["--resident_parts", "2"], ["--n_devices", "2"],
    ["--steps_per_dispatch", "4"], ["--locality_sampling"], ["--resume"],
    ["--profile_dir", "prof"], ["--op_timing"]])
def test_unported_flags_raise(tmp_path, flag):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcli.main(TINY + ["--device", "cpu", "--save_dir",
                          str(tmp_path)] + flag)


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(TINY + ["--save_dir", str(tmp_path)])
