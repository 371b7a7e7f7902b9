"""kernels: the grid encodings' forward work against its bound: the least
time of every forward grid call of the traced window (``counts.py``) over
the device time of every kernel and memset those calls launch, in %."""
from port_bench.trace import grid_part


def read(ctx):
    us = ctx.trace.device_us(lambda e: grid_part(e) == "fwd")
    if us <= 0 or ctx.work.get("grid_fwd", 0.0) <= 0:
        return None
    return 100.0 * ctx.work["grid_fwd"] / (us / 1e6)
