"""train_tokens_per_s: tokens of the training steps completed in the
window over the window's seconds (host clock, ending in a sync)."""


def read(run):
    n = run.counts.get("train_tokens")
    return None if not n or run.window_s <= 0 else n / run.window_s
