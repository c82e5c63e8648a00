"""The whole step's share of the card's peak: the operations the window's
training steps require (`portbench.counts.step`, a step's mean over a
sample of the window's batches, each operation at the peak of the
precision the configuration states for it), over the unprofiled
window's seconds."""


def read(rec):
    per_step = rec["work"]["step_s_at_peak"]
    w = rec["window"]
    if per_step is None or not w["steps"]:
        return None
    return 100.0 * per_step * w["steps"] / w["seconds"]
