"""step: the train steps that ran as a replay of a captured CUDA graph,
a step: the port's ``graph`` spans (``engine/step_graph.py``,
``utils/profiling.py``) over the traced window's steps. 1 where every step
replays, 0 where none does (the campaign's step is not captured). None
where the port records no spans."""
from fruitnerf_tpu_torch.utils import profiling


def read(ctx):
    spans = getattr(profiling, "spans", list)()
    if not spans:
        return None
    return sum(s.name == "graph" for s in spans) / ctx.steps
