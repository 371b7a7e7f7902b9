"""step: the host's synchronisations with the card a step that torch flags
(device-to-host copies, ``.item()``, ``.tolist()``, ``nonzero``), counted
in the port's spans (``utils/profiling.py``) over the traced window's
steps. Each one stops the host until the card has drained its queue. None
where the port records no spans."""
from fruitnerf_tpu_torch.utils import profiling


def read(ctx):
    spans = getattr(profiling, "spans", list)()
    if not spans:
        return None
    return sum(s.syncs for s in spans) / ctx.steps
