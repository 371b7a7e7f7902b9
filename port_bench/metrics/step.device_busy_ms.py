"""step: device milliseconds a step of every kernel, memset and copy in the
traced window."""


def read(ctx):
    if not ctx.trace.events:
        return None
    return ctx.trace.device_us(lambda e: True) / 1e3 / ctx.steps
