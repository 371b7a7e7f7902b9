"""kernels: the MLP products' work against its bound: the counted least time
of every MLP product of the traced window (the entry's ``mlp.<stage>``
pieces, ``semantic_nerf.py``: each layer's forward, weight gradient and the
input gradients the step needs, at the bf16 peak or its bytes at the
memory rate, whichever is larger) over the device time of every GEMM
kernel in the window, told by name, in %. Names, not launching ops: a
replayed step records no ATen op. None where the entry counts no MLP
pieces by stage or the window holds no GEMM kernel."""

GEMM_NAMES = ("gemm", "gemv", "nvjet", "xmma", "cutlass", "splitKreduce")


def is_gemm(e) -> bool:
    return any(k in e.name for k in GEMM_NAMES)


def read(ctx):
    least = sum(v for k, v in ctx.work.items() if k.startswith("mlp."))
    us = ctx.trace.device_us(is_gemm)
    if least <= 0 or us <= 0:
        return None
    return 100.0 * least / (us / 1e6)
