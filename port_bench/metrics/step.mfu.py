"""step: the whole step's share of the card's peak: the least time of the
step's required work (``counts.py``: MLP layers at the bf16 or fp32 peak,
the grid encodings and the optimizer at the memory rate), averaged over the
traced window's steps, over the wall time a step of the untraced window,
in %."""


def read(ctx):
    if ctx.wall_s_per_step <= 0:
        return None
    return 100.0 * ctx.work["total"] / ctx.steps / ctx.wall_s_per_step
