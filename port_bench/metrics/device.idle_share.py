"""device: the share of a step in which no kernel, memset or copy runs on the
card, in %: the traced window's device busy time a step (the union of its
device intervals) over the wall time a step of the untraced window. The
profiler slows the host, so the traced window's own wall would count its
cost as idle."""


def read(ctx):
    if ctx.wall_s_per_step <= 0 or not ctx.trace.events:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.steps / ctx.wall_s_per_step)
