"""model: device milliseconds a step of the matmuls (kernels launched by
aten::mm, aten::addmm, aten::bmm) in the traced window."""

MATMULS = ("aten::mm", "aten::addmm", "aten::bmm")


def read(ctx):
    us = ctx.trace.device_us(lambda e: bool(e.ops) and e.ops[0] in MATMULS)
    return us / 1e3 / ctx.steps if us > 0 else None
