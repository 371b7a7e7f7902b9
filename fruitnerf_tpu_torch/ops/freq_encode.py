"""The frequency encoding ``nerf_encode``: its CUDA kernel pair, their
autograd Functions, and the plain PyTorch versions.

``[..., D]`` -> ``[..., D + 2*D*F]``: the input, then every sine, then every
cosine of ``x_d * f_k``, each group dim-major, ``f_k = float32(pi) * 2^k``.
CPU tensors take the plain version; CUDA tensors launch the kernels
(``csrc/freq_encode.cu``, built into ``ops/hash_grid.py``'s library), which
write the encoding once, in the dtype the caller asks for (the MLP's), and
whose backward reads ``x`` and the gradient and recomputes the sines and
cosines. There is no fallback from one to the other. On the card both
equal the plain version bitwise: the forward its composition and cast, the
backward autograd of it, whose octave sum ``freq_encode_bwd_torch`` and the
kernel take in ATen's CUDA reduction order.

Under ``torch.func.vmap`` (the multi-scene step) the Functions' ``vmap``
rules launch each kernel once over every scene's rows: the encoding is the
same on every row, so scene s of such a launch equals scene s alone,
bitwise.
"""
from __future__ import annotations

import math

import torch

from . import hash_grid as hg

MAX_DIMS = 4  # FREQ_MAX_DIMS in csrc/freq_encode.cu
MAX_OCTAVES = 16  # FREQ_MAX_OCTAVES
DTYPES = (torch.float32, torch.bfloat16)


def freq_bands(num_frequencies: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """[F]: pi * 2^k, as the JAX twin computes them."""
    return math.pi * 2.0 ** torch.linspace(
        0.0, num_frequencies - 1, num_frequencies, dtype=dtype, device=device
    )


def freq_encode_torch(
    x: torch.Tensor, num_frequencies: int, dtype: torch.dtype | None = None
) -> torch.Tensor:
    """The plain version: the JAX twin's composition in ``x``'s dtype, then
    one cast to ``dtype`` (None: no cast)."""
    freqs = freq_bands(num_frequencies, x.dtype, x.device)
    scaled = (x[..., :, None] * freqs).flatten(-2)  # [..., D*F]
    out = torch.cat([x, torch.sin(scaled), torch.cos(scaled)], dim=-1)
    return out if dtype is None else out.to(dtype)


def _octave_sum(terms: torch.Tensor) -> torch.Tensor:
    """[..., F] -> [...]: the sum in the order ATen's CUDA sum reduces a
    contiguous row of F values (``reduce_kernel``: lane l of the B =
    2^floor(log2 F) lanes adds ``0 + u_l`` and ``0 + u_{l+B}``, and the
    lanes meet in a halving tree), the order autograd's sum over the
    octaves takes on the card."""
    octaves = terms.shape[-1]
    lanes = 1 << (octaves.bit_length() - 1)
    zero = torch.zeros_like(terms[..., 0])
    v = [zero + terms[..., k] for k in range(lanes)]
    for k in range(lanes, octaves):
        v[k - lanes] = v[k - lanes] + (zero + terms[..., k])
    while len(v) > 1:
        half = len(v) // 2
        v = [v[i] + v[i + half] for i in range(half)]
    return v[0]


def freq_encode_bwd_torch(
    x: torch.Tensor, grad: torch.Tensor, num_frequencies: int
) -> torch.Tensor:
    """The backward in closed form, the kernel's reference: ``x`` [..., D]
    float32 and the output's gradient [..., D + 2DF] -> dx [..., D] float32,
    ``g_d + sum_k f_k (g_sin,dk cos(x_d f_k) - g_cos,dk sin(x_d f_k))``, each
    term rounded as autograd's sin, cos and mul backwards round it, the
    octaves summed as ``_octave_sum`` sums them."""
    d, f = x.shape[-1], freq_bands(num_frequencies, device=x.device)
    g = grad.float()
    g_sin = g[..., d:d + d * num_frequencies].unflatten(-1, (d, num_frequencies))
    g_cos = g[..., d + d * num_frequencies:].unflatten(-1, (d, num_frequencies))
    s = x[..., :, None] * f
    return g[..., :d] + _octave_sum((g_sin * torch.cos(s) - g_cos * torch.sin(s)) * f)


def _check(dims: int, num_frequencies: int, dtype: torch.dtype) -> None:
    if not 1 <= dims <= MAX_DIMS:
        raise ValueError(f"the freq_encode kernels take 1..{MAX_DIMS} dims, got {dims}")
    if not 1 <= num_frequencies <= MAX_OCTAVES:
        raise ValueError(
            f"the freq_encode kernels take 1..{MAX_OCTAVES} octaves, got {num_frequencies}"
        )
    if dtype not in DTYPES:
        raise TypeError(f"the freq_encode kernels write float32 or bfloat16, not {dtype}")


def _cuda_operand(name: str, t: torch.Tensor, dtype: torch.dtype, align: int) -> None:
    """x is read a float at a time (4-byte aligned), the gradient as 16-byte
    vectors."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name}: expected a contiguous, {align}-byte aligned tensor")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (a copy where it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def freq_encode_fwd_cuda(
    x: torch.Tensor, num_frequencies: int, dtype: torch.dtype, scenes: int = 1
) -> torch.Tensor:
    """Forward kernel: x [..., D] float32 -> [..., D + 2DF] in ``dtype``,
    one launch over every row (``scenes``: the scenes those rows hold, for
    the launch count)."""
    dims = x.shape[-1]
    _check(dims, num_frequencies, dtype)
    _cuda_operand("x", x, torch.float32, 4)
    width = dims * (1 + 2 * num_frequencies)
    out = torch.empty((*x.shape[:-1], width), dtype=dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = hg._lib().freq_encode_fwd(
        x.data_ptr(), out.data_ptr(), x.numel() // dims, dims, num_frequencies,
        int(dtype == torch.bfloat16), stream,
    )
    hg._raise_on(err, "freq_encode_fwd")
    hg._count("freq_encode_fwd", scenes)
    return out


def freq_encode_bwd_cuda(
    x: torch.Tensor, grad: torch.Tensor, num_frequencies: int, scenes: int = 1
) -> torch.Tensor:
    """Backward kernel: x [..., D] float32 and the output's gradient
    [..., D + 2DF] (float32 or bfloat16) -> dx [..., D] float32."""
    dims = x.shape[-1]
    _check(dims, num_frequencies, grad.dtype)
    _cuda_operand("x", x, torch.float32, 4)
    width = dims * (1 + 2 * num_frequencies)
    if tuple(grad.shape) != (*x.shape[:-1], width):
        raise ValueError(
            f"grad: expected shape {(*x.shape[:-1], width)}, got {tuple(grad.shape)}"
        )
    _cuda_operand("grad", grad, grad.dtype, 16)
    dx = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = hg._lib().freq_encode_bwd(
        x.data_ptr(), grad.data_ptr(), dx.data_ptr(), x.numel() // dims, dims,
        num_frequencies, int(grad.dtype == torch.bfloat16), stream,
    )
    hg._raise_on(err, "freq_encode_bwd")
    hg._count("freq_encode_bwd", scenes)
    return dx


def _batched(info, in_dims, *tensors) -> list:
    """``torch.func.vmap`` operands with the batch axis first, contiguous and
    16-byte aligned; an unbatched one (dim None) is expanded to every scene."""
    return [
        _aligned(t.unsqueeze(0).expand(info.batch_size, *t.shape) if d is None
                 else t.movedim(d, 0))
        for t, d in zip(tensors, in_dims)
    ]


# Both Functions take the setup_context form, so that they run under
# torch.func (the multi-scene step is a vmap of grad); the backward launches
# through the second, whose own vmap rule launches once for every scene. It
# is not differentiable again.


class _FreqEncodeBwdCUDA(torch.autograd.Function):
    @staticmethod
    def forward(x, grad, num_frequencies):
        return freq_encode_bwd_cuda(x, _aligned(grad), num_frequencies)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, x, grad, num_frequencies):
        x, grad = _batched(info, in_dims[:2], x, grad)
        return freq_encode_bwd_cuda(x, grad, num_frequencies, info.batch_size), 0


class _FreqEncodeCUDA(torch.autograd.Function):
    @staticmethod
    def forward(x, num_frequencies, dtype):
        return freq_encode_fwd_cuda(x, num_frequencies, dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, num_frequencies, _ = inputs
        ctx.num_frequencies = num_frequencies
        ctx.save_for_backward(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return _FreqEncodeBwdCUDA.apply(x, grad, ctx.num_frequencies), None, None

    @staticmethod
    def vmap(info, in_dims, x, num_frequencies, dtype):
        (x,) = _batched(info, in_dims[:1], x)
        return freq_encode_fwd_cuda(x, num_frequencies, dtype, info.batch_size), 0


def freq_encode(
    x: torch.Tensor, num_frequencies: int, dtype: torch.dtype | None = None
) -> torch.Tensor:
    """[..., D] -> [..., D + 2DF] in ``dtype`` (None: float32, ``x``'s).
    CPU tensors take the plain version; CUDA tensors launch the kernels,
    which take float32 ``x``, 1..4 dims and 1..16 octaves and write float32
    or bfloat16."""
    if x.device.type == "cpu":
        return freq_encode_torch(x, num_frequencies, dtype)
    if x.device.type != "cuda":
        raise ValueError(f"nerf_encode runs on cpu or cuda, not {x.device}")
    return _FreqEncodeCUDA.apply(x.contiguous(), num_frequencies, dtype or torch.float32)
