"""loop: the host's own work a step: process CPU milliseconds a step over the
untraced window of the traced run (the profiler's own cost left out)."""


def read(ctx):
    return ctx.host_cpu_s_per_step * 1e3
