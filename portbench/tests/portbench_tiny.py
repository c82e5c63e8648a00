"""Tiny cells for the tests: the real configurations and traffic mixes
at their widths, on a 3,000-node graph with batches of 64 and 256
columns drawn a layer. The tiny cells are named as the full-size cells
that use (or used) the same configuration and traffic."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import manifest  # noqa: E402

DATASET = "synthetic:nodes=3000,deg=14,feats=602,classes=41"

# configuration and traffic of each tiny cell
CELLS = {"sage-reddit-g8": ("graphsage-reddit", "ladies-b512-g8"),
         "gat-reddit-g8": ("gat-reddit", "ladies-b512-g8"),
         "sage-reddit-eager": ("graphsage-reddit", "ladies-b512-eager")}

# Limits of the compared numbers on the CPU, where a grouped dispatch is
# cut to 2 steps a replay (3 checked steps, as in an eager cell), set as
# the cells' are (between the program's readings and the control's or
# the faults'), from `portbench/calibrate.py --tiny --device cpu` over
# eight seeds a cell. The program read at most 1.3e-7 / 7.2e-6 / 8.1e-5
# / 5.6e-7 / 2.5e-4 (first loss, median loss, largest step's loss,
# gradient, change) in the GraphSAGE cells and 1.3e-7 / 6.7e-8 / 1.3e-7
# / 1.9e-7 / 1.8e-7 in GAT's; the TF32 control at least 2.0e-7 /
# 1.3e-5 / 6.5e-4 / 6.9e-5 / 1.4e-3 and 0 / 1.1e-5 / 2.5e-5 / 1.1e-4 /
# 1.4e-5; the half-batch fault at least 7.2e-5 / 6.8e-4 / 0.018 / 0.29
# / 0.037 and 1.5e-5 / 1.8e-4 / 3.6e-4 / 0.30 / 0.063; a stale last
# step at least - / - / 6.8e-3 / - / 8.1e-3 and - / - / 3.8e-4 / - /
# 0.072. The cells' own limits (portbench/limits/) are set from the
# card at full size, where the CPU path's rounding is not the one
# compared.
_SAGE = {"first_loss_gap": 1e-6, "loss_gap": 1e-4, "step_gap": 2.5e-4,
         "grad_gap": 1e-5, "change_gap": 7e-4}
LIMITS = {"sage-reddit-g8": _SAGE, "sage-reddit-eager": _SAGE,
          "gat-reddit-g8": dict(_SAGE, step_gap=2e-6)}

# Limits on the card, at each traffic's own steps a dispatch (9 checked
# steps at G = 8), from `portbench/calibrate.py --tiny` on the card over
# twelve seeds a cell (this file's test seed among them). The program
# read at most 6.7e-8 / 8.8e-5 / 6.1e-4 / 1.1e-6 / 1.3e-3 (GraphSAGE,
# G = 8: Adam's chaos at lr 0.04 over 9 steps), 6.7e-8 / 2.1e-7 /
# 4.4e-7 / 1.6e-7 / 8.2e-6 (GAT, G = 8) and 6.7e-8 / 1.8e-5 / 1.7e-4 /
# 7.1e-7 / 5.1e-4 (GraphSAGE, eager); the two TF32 controls at least
# 0 / 1.6e-4 / 1.3e-3 / 5.5e-5 / 1.7e-3, 0 / 2.0e-6 / 2.5e-5 / 1.1e-4 /
# 4.4e-5 and 0 / 1.1e-5 / 3.9e-4 / 5.6e-5 / 1.0e-3; the half-batch fault
# at least 1.7e-4 / 7.5e-3 / 0.049 / 0.28 / 0.049, 2.9e-4 / 1.2e-3 /
# 3.0e-3 / 0.37 / 0.087 and 1.7e-4 / 1.3e-3 / 0.022 / 0.28 / 0.045; a
# stale last step at least - / - / 2.6e-3 / - / 5.2e-4, - / - / 2.6e-4
# / - / 4.4e-3 and - / - / 0.023 / - / 0.044.
CARD_LIMITS = {
    "sage-reddit-g8": {"first_loss_gap": 1e-6, "loss_gap": 2.5e-4,
                       "step_gap": 2e-3, "grad_gap": 1e-5,
                       "change_gap": 4e-3},
    "gat-reddit-g8": {"first_loss_gap": 1e-6, "loss_gap": 8e-7,
                      "step_gap": 3e-6, "grad_gap": 1e-5,
                      "change_gap": 2.5e-5},
    "sage-reddit-eager": {"first_loss_gap": 1e-6, "loss_gap": 1e-4,
                          "step_gap": 1e-3, "grad_gap": 1e-5,
                          "change_gap": 2e-3},
}


def tiny(cell_name: str, card: bool = False):
    """``(cell, config, traffic)`` of a cell cut to the tiny graph; off
    the card a grouped dispatch is cut to 2 steps a replay (3 checked
    steps, as :data:`LIMITS` were read)."""
    config, traffic = CELLS[cell_name]
    cell = {"name": cell_name, "config": "tiny-" + config,
            "traffic": traffic, "chips": 1}
    cfg = manifest.config(config)
    cfg.update(dataset=DATASET, hot_k=512)
    tr = manifest.traffic(traffic)
    tr.update(batch_size=64, samp_num=256, pool_num=2)
    if not card:
        tr.update(steps_per_dispatch=min(tr["steps_per_dispatch"], 2))
    return cell, cfg, tr


def limits(cell_name: str, card: bool = False) -> dict:
    return (CARD_LIMITS if card else LIMITS)[cell_name]


def spec_of(cell, cfg, tr):
    spec = manifest.spec(cfg, tr)
    spec["config"] = cell["config"]
    return spec
