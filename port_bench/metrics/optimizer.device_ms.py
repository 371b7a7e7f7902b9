"""optimizer: device milliseconds a step of the optimizer's update: kernels
launched inside ``Optimizer.step`` (Adam, RAdam) or by ``aten::_foreach_*``
and ``aten::_fused_adam*`` ops, in the traced window."""


def _mine(e):
    return any(o.startswith(("Optimizer.step#", "aten::_foreach", "aten::_fused_adam"))
               for o in e.ops)


def read(ctx):
    us = ctx.trace.device_us(_mine)
    return us / 1e3 / ctx.steps if us > 0 else None
