"""model: host milliseconds a step of the model's forward: the self time of
the port's forward stage spans (``rays``, ``sampler.*``, ``proposal.*``,
``field``, ``render``, ``losses``, ``sparsity``; ``utils/profiling.py``)
in the traced window, scaled to the untraced window as the share of the
traced window's wall they take times the untraced wall a step (the
profiler slows the host). None where the port records no spans."""
from fruitnerf_tpu_torch.utils import profiling

STAGES = ("rays", "field", "render", "losses", "sparsity")
PREFIXES = ("sampler.", "proposal.")


def read(ctx):
    spans = getattr(profiling, "spans", list)()
    mine = [ns for s, ns in zip(spans, profiling.self_ns(spans)) if s.name in STAGES
            or s.name.startswith(PREFIXES)] if spans else []
    if not mine or ctx.trace.window_s <= 0:
        return None
    return sum(mine) / 1e6 / ctx.trace.window_s * ctx.wall_s_per_step
