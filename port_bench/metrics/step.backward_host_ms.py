"""step: host milliseconds a step of the backward: the self time of the
port's ``backward`` span, or on the campaign of its ``loss_and_grad`` span
(the vmapped loss and gradient, whose forward stages are child spans;
``utils/profiling.py``), in the traced window, scaled to the untraced
window as the share of the traced window's wall it takes times the
untraced wall a step (the profiler slows the host). None where the port
records no spans."""
from fruitnerf_tpu_torch.utils import profiling

STAGES = ("backward", "loss_and_grad")


def read(ctx):
    spans = getattr(profiling, "spans", list)()
    mine = [ns for s, ns in zip(spans, profiling.self_ns(spans))
            if s.name in STAGES] if spans else []
    if not mine or ctx.trace.window_s <= 0:
        return None
    return sum(mine) / 1e6 / ctx.trace.window_s * ctx.wall_s_per_step
