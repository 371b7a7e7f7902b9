"""Multiresolution grid encodings: the CUDA kernels, their build, their
autograd Functions, and the plain PyTorch versions. Twin of
``fruitnerf_tpu/ops/pallas/hash_grid.py``.

Every table is ONE flat float32 parameter; level l occupies rows
``offset_l .. offset_l + T_l`` (``CellLayout``).

* ``cell_encode`` (cell mode v2, TPU kernels K1/K2): ``[sum_l T_l, 16]``,
  row t holds cell t's 8 corners x 2 features (corner c = 4cx + 2cy + cz
  at columns 2c, 2c+1). The JAX package keeps per-level ``[K_l, LO_l*16]``
  arrays with the same row-major content.
* ``grid_encode_flat(mode="corner")`` (K3/K4): ``[L*T, F]``, row t of level
  l holds corner entry t's F features. The JAX package keeps
  ``[L, 128, F*T/128]`` with f-major lanes.
* ``grid_encode_flat(mode="cell")`` (cell v1, K5/K6): cell mode at one
  uniform T, ``[L*T, 16]``; it runs the cell-mode kernels at that layout.

``fruitnerf_tpu_torch.bridge`` converts the layouts. Each encoding takes
the plain version for CPU tensors and launches the kernels
(``csrc/cell_encode.cu``, ``csrc/corner_encode.cu``) for CUDA tensors;
there is no fallback from one to the other. The kernels are compiled with
nvcc for sm_90a at first use into
``fruitnerf_tpu_torch/_build/<source hash>/`` and loaded with ctypes. The
backward kernels sum dTable in 64-bit fixed point (``csrc/fixed_sum.cuh``),
so a backward repeats bitwise.

The kernels take a leading scene axis, the counterpart of ``jax.vmap`` over
the Pallas calls: under ``torch.func.vmap`` (the multi-scene step,
``parallel/multi_scene.py``) the autograd Functions' ``vmap`` rules launch
each kernel once for all S scenes, and scene s of such a launch equals a
launch of scene s alone, bitwise. The plain versions batch under
``torch.func.vmap`` as they are.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

# instant-ngp spatial hash primes (uint32)
_P1 = 2654435761
_P2 = 805459861
_MASK32 = 0xFFFFFFFF
MAX_LEVELS = 32  # CELL_MAX_LEVELS and CORNER_MAX_LEVELS in csrc/
MAX_CORNER_FEATURES = 8  # CORNER_MAX_FEATURES in csrc/corner_encode.cu

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD = Path(__file__).resolve().parents[1] / "_build"
_SOURCES = ("cell_encode.cu", "corner_encode.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Launch counts of the kernels, raised by one where each is launched, and
# the scenes those launches took (S for a scene-batched launch, else 1).
LAUNCHES = {
    "cell_encode_fwd": 0, "cell_encode_bwd": 0,
    "corner_encode_fwd": 0, "corner_encode_bwd": 0,
}
SCENES = dict(LAUNCHES)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        SCENES[k] = 0


def _count(name: str, scenes: int) -> None:
    LAUNCHES[name] += 1
    SCENES[name] += scenes


def _pow2ceil(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def cell_level_layout(resolutions, table_size, radix: int):
    """Per-level (T_l, K_l, LO_l, use_direct), as the JAX package's
    ``cell_level_layout``: T_l = max(128, min(cap_l, pow2ceil(res^3))),
    direct indexing whenever the dense cell grid fits. ``table_size`` is one
    cap (int) or a per-level tuple of caps."""
    caps = (
        tuple(int(c) for c in table_size)
        if isinstance(table_size, (tuple, list))
        else (int(table_size),) * len(resolutions)
    )
    if len(caps) != len(resolutions):
        raise ValueError(
            f"per-level table caps: got {len(caps)} caps for "
            f"{len(resolutions)} levels"
        )
    out = []
    for res, cap in zip(resolutions, caps):
        cells = int(res) ** 3
        t_l = max(128, min(cap, _pow2ceil(cells)))
        k_l = min(int(radix), t_l)
        out.append((t_l, k_l, t_l // k_l, cells <= t_l))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class CellLayout:
    """Where each level lives in a flat table: its rows and whether its
    index is direct (else hashed). Used by both modes."""

    resolutions: tuple[int, ...]
    rows: tuple[int, ...]  # T_l
    direct: tuple[bool, ...]

    @property
    def num_levels(self) -> int:
        return len(self.resolutions)

    @property
    def offsets(self) -> tuple[int, ...]:
        out, acc = [], 0
        for t in self.rows:
            out.append(acc)
            acc += t
        return tuple(out)

    @property
    def total_rows(self) -> int:
        return sum(self.rows)

    @classmethod
    def from_levels(cls, resolutions, level_layout) -> "CellLayout":
        return cls(
            resolutions=tuple(int(r) for r in resolutions),
            rows=tuple(int(t) for t, _, _, _ in level_layout),
            direct=tuple(bool(d) for _, _, _, d in level_layout),
        )


def uniform_cell_layout(resolutions, table_size) -> CellLayout:
    """Cell v1 (K5/K6): T cells at every level, direct when res^3 <= T, as
    the JAX package's ``_smem_level_arrays``."""
    res = tuple(int(r) for r in resolutions)
    t = int(table_size)
    return CellLayout(res, (t,) * len(res), tuple(r**3 <= t for r in res))


def corner_layout(resolutions, table_size) -> CellLayout:
    """Corner mode (K3/K4): T corner entries at every level, direct with
    stride res+1 when the (res+1)^3 corners fit."""
    res = tuple(int(r) for r in resolutions)
    t = int(table_size)
    return CellLayout(res, (t,) * len(res), tuple((r + 1) ** 3 <= t for r in res))


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path; the reference the kernels are held to)
# ---------------------------------------------------------------------------

# corner bits of c = 4cx + 2cy + cz
_CX = (0, 0, 0, 0, 1, 1, 1, 1)
_CY = (0, 0, 1, 1, 0, 0, 1, 1)
_CZ = (0, 1, 0, 1, 0, 1, 0, 1)


def _cell_rows(positions: torch.Tensor, layout: CellLayout):
    """-> (flat row index [P, L] int64, valid [P, L] bool, fractions
    [P, L, 3] float32). Index arithmetic in int64, the hash masked to 32
    bits as the kernel's uint32 products wrap."""
    dev = positions.device
    res_f = torch.tensor(layout.resolutions, dtype=torch.float32, device=dev)
    s = positions[:, None, :] * res_f[None, :, None]  # [P, L, 3]
    cell = torch.floor(s)
    frac = s - cell
    ix, iy, iz = cell.long().unbind(-1)  # [P, L]
    res = torch.tensor(layout.resolutions, dtype=torch.int64, device=dev)
    flat, valid = _hash_or_direct(ix, iy, iz, res, layout)
    return flat, valid, frac


def cell_encode_torch(
    table: torch.Tensor, positions: torch.Tensor, layout: CellLayout
) -> torch.Tensor:
    """table [sum T_l, 16] f32, positions [P, 3] in [0,1)^3 -> [P, 2L] f32,
    level-major. Gather plus trilinear weights; autograd gives dTable and
    dPositions. A row index outside [0, T_l) reads a zero row."""
    p = positions.shape[0]
    flat, valid, frac = _cell_rows(positions.float(), layout)
    rows = table[flat]  # [P, L, 16]
    rows = torch.where(valid[..., None], rows, torch.zeros_like(rows))
    dev = positions.device
    bits = [torch.tensor(b, dtype=torch.bool, device=dev) for b in (_CX, _CY, _CZ)]
    tx, ty, tz = (frac[..., a : a + 1] for a in range(3))  # [P, L, 1]
    wx = torch.where(bits[0], tx, 1.0 - tx)  # [P, L, 8]
    wy = torch.where(bits[1], ty, 1.0 - ty)
    wz = torch.where(bits[2], tz, 1.0 - tz)
    w8 = wx * wy * wz
    out = (rows.view(p, layout.num_levels, 8, 2) * w8[..., None]).sum(-2)
    return out.reshape(p, 2 * layout.num_levels)


def _hash_or_direct(ix, iy, iz, stride, layout: CellLayout):
    """Integer coordinates [P, L, ...] int64 -> (flat row index, valid):
    direct ``ix + iy*stride + iz*stride^2`` or the instant-ngp hash masked
    to 32 bits (the kernels' uint32 products wrap), then ``& (T_l - 1)``.
    An index outside [0, T_l) is invalid and clamped."""
    dev = ix.device
    extra = (1,) * (ix.dim() - 2)  # broadcast the per-level values over [P, L, ...]
    rows = torch.tensor(layout.rows, dtype=torch.int64, device=dev).view(-1, *extra)
    direct = torch.tensor(layout.direct, dtype=torch.bool, device=dev).view(-1, *extra)
    offsets = torch.tensor(layout.offsets, dtype=torch.int64, device=dev).view(-1, *extra)
    direct_idx = ix + iy * stride + iz * stride * stride
    hashed = (ix ^ ((iy * _P1) & _MASK32) ^ ((iz * _P2) & _MASK32)) & (rows - 1)
    idx = torch.where(direct, direct_idx, hashed)
    valid = (idx >= 0) & (idx < rows)
    return offsets + torch.minimum(idx.clamp_min(0), rows - 1), valid


def grid_encode_corner_torch(
    table: torch.Tensor, positions: torch.Tensor, layout: CellLayout, features: int
) -> torch.Tensor:
    """Corner mode, the twin of the JAX package's ``grid_encode_ref``:
    table [L*T, F] f32, positions [P, 3] in [0,1]^3 -> [P, L*F] f32,
    level-major. Corner c = 4cx + 2cy + cz of the cell is entry
    (ix+cx, iy+cy, iz+cz), direct with stride res+1 or hashed; autograd
    gives dTable and dPositions. An index outside [0, T) reads zero, as the
    Pallas kernel's one-hot does (``grid_encode_ref``'s take gives NaN)."""
    p, dev = positions.shape[0], positions.device
    res_f = torch.tensor(layout.resolutions, dtype=torch.float32, device=dev)
    s = positions.float()[:, None, :] * res_f[None, :, None]  # [P, L, 3]
    f0 = torch.floor(s)
    frac = s - f0
    bits = torch.tensor((_CX, _CY, _CZ), dtype=torch.int64, device=dev)  # [3, 8]
    ix, iy, iz = (f0.long()[..., :, None] + bits).unbind(-2)  # [P, L, 8]
    stride = torch.tensor(layout.resolutions, dtype=torch.int64, device=dev)[:, None] + 1
    flat, valid = _hash_or_direct(ix, iy, iz, stride, layout)
    rows = table[flat]  # [P, L, 8, F]
    rows = torch.where(valid[..., None], rows, torch.zeros_like(rows))
    on = bits.bool()
    tx, ty, tz = (frac[..., a : a + 1] for a in range(3))  # [P, L, 1]
    w8 = torch.where(on[0], tx, 1.0 - tx) * torch.where(on[1], ty, 1.0 - ty) \
        * torch.where(on[2], tz, 1.0 - tz)  # [P, L, 8]
    out = (rows * w8[..., None]).sum(-2)  # [P, L, F]
    return out.reshape(p, layout.num_levels * features)


# ---------------------------------------------------------------------------
# the CUDA kernels: build, load, launch
# ---------------------------------------------------------------------------


class KernelBuildError(RuntimeError):
    pass


def _find_nvcc() -> str:
    """nvcc of the toolkit PyTorch finds (CUDA_HOME, CUDA_PATH, the PATH or
    the default install), else the PATH's."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _source_key(sources) -> str:
    """Hash of the flags, the sources and the headers beside them."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted({x for s in sources for x in s.parent.glob("*.cuh")})
    for path in [*sources, *headers]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


@dataclasses.dataclass
class BuildInfo:
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output (-Xptxas -v: registers, spills)


def build_library(sources, build_dir: Path) -> tuple[ctypes.CDLL, BuildInfo]:
    """Compile CUDA ``sources`` into one shared library under
    ``build_dir/<source hash>/`` (once per source hash), load it, and declare
    the kernels' C interface. Returns the library and its ``BuildInfo``."""
    sources = [Path(s) for s in sources]
    out_dir = Path(build_dir) / _source_key(sources)
    lib_path = out_dir / "libfruitnerf_kernels.so"
    log_path = out_dir / "nvcc.log"
    seconds = 0.0
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"libfruitnerf_kernels.{os.getpid()}.so"
        cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(s) for s in sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise KernelBuildError(f"nvcc failed ({proc.returncode}):\n{log}")
        log_path.write_text(log)
        os.replace(tmp, lib_path)  # atomic: a racing build finds a whole file
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    arr = ctypes.POINTER(ctypes.c_int)
    signatures = {
        # (pointers..., points, scenes, position stride, table stride, ...)
        "cell_encode_fwd": ([ptr, ptr, ptr, i32, i32, i64, i64, i32, arr, arr, arr, arr, ptr],
                            i32),
        "cell_encode_bwd": ([ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i64, i64, i32, i32, arr,
                             arr, arr, arr, ptr], i32),
        "cell_encode_bwd_work_bytes": ([i64, i32, i32], i64),
        "corner_encode_fwd": ([ptr, ptr, ptr, i32, i32, i64, i64, i32, i32, arr, arr, arr, arr,
                               ptr], i32),
        "corner_encode_bwd": ([ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i64, i64, i32, i32, i32,
                               arr, arr, arr, arr, ptr], i32),
        "corner_encode_bwd_work_bytes": ([i64, i32, i32, i32], i64),
    }
    for name, (argtypes, restype) in signatures.items():
        if hasattr(lib, name):  # a library of one source has that source's functions
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = restype
    info = BuildInfo(lib_path, seconds, log_path.read_text() if log_path.exists() else "")
    return lib, info


_LIB: ctypes.CDLL | None = None
_BUILD_INFO: BuildInfo | None = None


def build_kernels() -> BuildInfo:
    """Compile ``csrc/*.cu`` into a shared library (once per source hash)
    and load it. Returns where it lies, the seconds the build took and the
    compiler's output."""
    global _LIB, _BUILD_INFO
    if _BUILD_INFO is None:
        _LIB, _BUILD_INFO = build_library([_CSRC / s for s in _SOURCES], _BUILD)
    return _BUILD_INFO


def _lib() -> ctypes.CDLL:
    if _LIB is None:
        build_kernels()
    return _LIB


def _level_arrays(layout: CellLayout):
    n = layout.num_levels
    if not 1 <= n <= MAX_LEVELS:
        raise ValueError(f"cell kernels take 1..{MAX_LEVELS} levels, got {n}")
    arr = ctypes.c_int * n
    return (
        arr(*layout.resolutions), arr(*layout.rows), arr(*layout.offsets),
        arr(*(int(d) for d in layout.direct)),
    )


def _operand(name: str, t: torch.Tensor, inner: tuple, device: torch.device,
             align: int = 4) -> tuple[int | None, int]:
    """Check a kernel operand of shape ``inner`` or ``[S, *inner]`` ->
    (S, or None without a scene axis; the scene stride in floats). A
    batched operand is contiguous; an operand without the scene axis is
    shared by every scene (stride 0). The cell kernels read the table as
    float4 (16-byte aligned, every scene's too); the corner kernels read table rows as float2
    or float4 where F is 2, 4 or 8."""
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    batched = t.dim() == len(inner) + 1
    if tuple(t.shape[batched:]) != inner or t.dim() not in (len(inner), len(inner) + 1):
        raise ValueError(f"{name}: expected shape {inner} or [S, *{inner}], got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    stride = math.prod(inner) if batched else 0
    if t.data_ptr() % align or (stride * 4) % align:
        raise ValueError(f"{name}: expected a {align}-byte aligned tensor (every scene)")
    return (t.shape[0] if batched else None), stride


def _scenes(*counts) -> int | None:
    """The launch's scene count from its operands' (None: no scene axis)."""
    given = {c for c in counts if c is not None}
    if len(given) > 1:
        raise ValueError(f"operands of {sorted(given)} scenes")
    if given and not 1 <= min(given) <= 65535:
        raise ValueError(f"the kernels take 1..65535 scenes, got {min(given)}")
    return given.pop() if given else None


def _grad_operand(grad: torch.Tensor, scenes: int | None, shape: tuple, device) -> torch.Tensor:
    """The backward's output gradient, contiguous, as [S, *shape] (or
    ``shape`` without a scene axis)."""
    want = shape if scenes is None else (scenes, *shape)
    if tuple(grad.shape) != want:
        raise ValueError(f"grad: expected shape {want}, got {tuple(grad.shape)}")
    grad = grad.contiguous()
    _operand("grad", grad, shape, device)
    return grad


def _work(nbytes: int, device: torch.device) -> torch.Tensor:
    """A backward kernel's work buffer: its fixed-point dTable sums and
    column maxima, which the kernel zeroes itself."""
    return torch.empty(nbytes, dtype=torch.uint8, device=device)


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def _out(scenes: int | None, shape: tuple, device) -> torch.Tensor:
    return torch.empty(shape if scenes is None else (scenes, *shape), dtype=torch.float32,
                       device=device)


def _positions_rows(positions: torch.Tensor) -> int:
    if positions.dim() not in (2, 3):
        raise ValueError(f"positions: expected [P, 3] or [S, P, 3], got {tuple(positions.shape)}")
    return positions.shape[-2]


def cell_encode_fwd_cuda(
    table: torch.Tensor, positions: torch.Tensor, layout: CellLayout
) -> torch.Tensor:
    """Forward kernel (K1): table [sum T_l, 16], positions [P, 3] ->
    [P, 2L] float32. Either may lead with a scene axis S (the other is
    shared by every scene): one launch -> [S, P, 2L]."""
    dev = table.device
    p = _positions_rows(positions)
    s_table, t_stride = _operand("table", table, (layout.total_rows, 16), dev, align=16)
    s_pos, p_stride = _operand("positions", positions, (p, 3), dev)
    scenes = _scenes(s_table, s_pos)
    out = _out(scenes, (p, 2 * layout.num_levels), dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().cell_encode_fwd(
        positions.data_ptr(), table.data_ptr(), out.data_ptr(), p, scenes or 1, p_stride,
        t_stride, layout.num_levels, *_level_arrays(layout), stream,
    )
    _raise_on(err, "cell_encode_fwd")
    _count("cell_encode_fwd", scenes or 1)
    return out


def cell_encode_bwd_cuda(
    table: torch.Tensor, positions: torch.Tensor, grad: torch.Tensor,
    layout: CellLayout, needs_pos_grad: bool,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Backward kernel (K2): -> (dTable [sum T_l, 16], dPositions [P, 3] or
    None). With a scene axis on any operand, one launch -> ([S, sum T_l,
    16], [S, P, 3] or None), each scene's own gradients."""
    dev = table.device
    p = _positions_rows(positions)
    s_table, t_stride = _operand("table", table, (layout.total_rows, 16), dev, align=16)
    s_pos, p_stride = _operand("positions", positions, (p, 3), dev)
    s_grad = grad.shape[0] if grad.dim() == 3 else None
    scenes = _scenes(s_table, s_pos, s_grad)
    grad = _grad_operand(grad, scenes, (p, 2 * layout.num_levels), dev)
    dtable = _out(scenes, (layout.total_rows, 16), dev)
    dpos = _out(scenes, (p, 3), dev) if needs_pos_grad else None
    work = _work(_lib().cell_encode_bwd_work_bytes(
        layout.total_rows, layout.num_levels, scenes or 1), dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().cell_encode_bwd(
        positions.data_ptr(), table.data_ptr(), grad.data_ptr(),
        dtable.data_ptr(), dpos.data_ptr() if needs_pos_grad else None,
        work.data_ptr(), p, scenes or 1, p_stride, t_stride, int(needs_pos_grad),
        layout.num_levels, *_level_arrays(layout), stream,
    )
    _raise_on(err, "cell_encode_bwd")
    _count("cell_encode_bwd", scenes or 1)
    return dtable, dpos


def _scene_first(in_dims, *tensors) -> list:
    """``torch.func.vmap`` operands with their scene axis first, contiguous;
    an unbatched one (dim None) stays as it is, shared by every scene."""
    return [t if d is None else t.movedim(d, 0).contiguous() for t, d in zip(tensors, in_dims)]


def _pos_grad_dims(dpos) -> int | None:
    return None if dpos is None else 0


# The autograd Functions take the setup_context form, so that they run under
# torch.func: ``vmap(grad(...))`` calls each one's ``vmap`` rule, which
# launches the kernel once for every scene. A backward launches its kernel
# through a second Function, whose own ``vmap`` rule does the same under a
# vmap (a ctypes call cannot take the batched tensors a vmapped backward
# sees). The second Function is not differentiable again.


class _CellEncodeBwdCUDA(torch.autograd.Function):
    @staticmethod
    def forward(table, positions, grad, layout, needs_pos_grad):
        return cell_encode_bwd_cuda(table, positions, grad.contiguous(), layout, needs_pos_grad)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, table, positions, grad, layout, needs_pos_grad):
        table, positions, grad = _scene_first(in_dims[:3], table, positions, grad)
        dtable, dpos = cell_encode_bwd_cuda(table, positions, grad, layout, needs_pos_grad)
        return (dtable, dpos), (0, _pos_grad_dims(dpos))


class _CellEncodeCUDA(torch.autograd.Function):
    @staticmethod
    def forward(table, positions, layout):
        return cell_encode_fwd_cuda(table, positions, layout)

    @staticmethod
    def setup_context(ctx, inputs, output):
        table, positions, layout = inputs
        ctx.layout = layout
        ctx.save_for_backward(table, positions)

    @staticmethod
    def backward(ctx, grad):
        table, positions = ctx.saved_tensors
        dtable, dpos = _CellEncodeBwdCUDA.apply(
            table, positions, grad, ctx.layout, ctx.needs_input_grad[1])
        return (dtable if ctx.needs_input_grad[0] else None), dpos, None

    @staticmethod
    def vmap(info, in_dims, table, positions, layout):
        table, positions = _scene_first(in_dims[:2], table, positions)
        return cell_encode_fwd_cuda(table, positions, layout), 0


def _device_type(table: torch.Tensor, positions: torch.Tensor, what: str) -> str:
    if table.device != positions.device:
        raise ValueError(
            f"table on {table.device} but positions on {positions.device}"
        )
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {table.device}")
    return table.device.type


def cell_encode(
    table: torch.Tensor, positions: torch.Tensor, layout: CellLayout
) -> torch.Tensor:
    """[P, 3] positions in [0,1)^3 -> [P, 2L] features. CPU tensors take the
    plain version; CUDA tensors launch the kernels, whose backward computes
    dPositions only when ``positions`` needs a gradient."""
    if _device_type(table, positions, "cell_encode") == "cpu":
        return cell_encode_torch(table, positions, layout)
    return _CellEncodeCUDA.apply(table, positions.contiguous(), layout)


def _check_features(features: int):
    if not 1 <= features <= MAX_CORNER_FEATURES:
        raise ValueError(
            f"corner kernels take 1..{MAX_CORNER_FEATURES} features a level, got {features}"
        )


def corner_encode_fwd_cuda(
    table: torch.Tensor, positions: torch.Tensor, layout: CellLayout, features: int
) -> torch.Tensor:
    """Forward kernel (K3): table [L*T, F], positions [P, 3] -> [P, L*F]
    float32. Either may lead with a scene axis S (the other is shared by
    every scene): one launch -> [S, P, L*F]."""
    _check_features(features)
    dev = table.device
    p = _positions_rows(positions)
    s_table, t_stride = _operand("table", table, (layout.total_rows, features), dev, align=16)
    s_pos, p_stride = _operand("positions", positions, (p, 3), dev)
    scenes = _scenes(s_table, s_pos)
    out = _out(scenes, (p, features * layout.num_levels), dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().corner_encode_fwd(
        positions.data_ptr(), table.data_ptr(), out.data_ptr(), p, scenes or 1, p_stride,
        t_stride, features, layout.num_levels, *_level_arrays(layout), stream,
    )
    _raise_on(err, "corner_encode_fwd")
    _count("corner_encode_fwd", scenes or 1)
    return out


def corner_encode_bwd_cuda(
    table: torch.Tensor, positions: torch.Tensor, grad: torch.Tensor,
    layout: CellLayout, features: int, needs_pos_grad: bool,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Backward kernel (K4): -> (dTable [L*T, F], dPositions [P, 3] or
    None). With a scene axis on any operand, one launch -> ([S, L*T, F],
    [S, P, 3] or None), each scene's own gradients."""
    _check_features(features)
    dev = table.device
    p = _positions_rows(positions)
    s_table, t_stride = _operand("table", table, (layout.total_rows, features), dev, align=16)
    s_pos, p_stride = _operand("positions", positions, (p, 3), dev)
    s_grad = grad.shape[0] if grad.dim() == 3 else None
    scenes = _scenes(s_table, s_pos, s_grad)
    grad = _grad_operand(grad, scenes, (p, features * layout.num_levels), dev)
    dtable = _out(scenes, (layout.total_rows, features), dev)
    dpos = _out(scenes, (p, 3), dev) if needs_pos_grad else None
    work = _work(_lib().corner_encode_bwd_work_bytes(
        layout.total_rows, features, layout.num_levels, scenes or 1), dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().corner_encode_bwd(
        positions.data_ptr(), table.data_ptr(), grad.data_ptr(),
        dtable.data_ptr(), dpos.data_ptr() if needs_pos_grad else None,
        work.data_ptr(), p, scenes or 1, p_stride, t_stride, features, int(needs_pos_grad),
        layout.num_levels, *_level_arrays(layout), stream,
    )
    _raise_on(err, "corner_encode_bwd")
    _count("corner_encode_bwd", scenes or 1)
    return dtable, dpos


class _CornerEncodeBwdCUDA(torch.autograd.Function):
    @staticmethod
    def forward(table, positions, grad, layout, features, needs_pos_grad):
        return corner_encode_bwd_cuda(
            table, positions, grad.contiguous(), layout, features, needs_pos_grad)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, table, positions, grad, layout, features, needs_pos_grad):
        table, positions, grad = _scene_first(in_dims[:3], table, positions, grad)
        dtable, dpos = corner_encode_bwd_cuda(
            table, positions, grad, layout, features, needs_pos_grad)
        return (dtable, dpos), (0, _pos_grad_dims(dpos))


class _CornerEncodeCUDA(torch.autograd.Function):
    @staticmethod
    def forward(table, positions, layout, features):
        return corner_encode_fwd_cuda(table, positions, layout, features)

    @staticmethod
    def setup_context(ctx, inputs, output):
        table, positions, layout, features = inputs
        ctx.layout, ctx.features = layout, features
        ctx.save_for_backward(table, positions)

    @staticmethod
    def backward(ctx, grad):
        table, positions = ctx.saved_tensors
        dtable, dpos = _CornerEncodeBwdCUDA.apply(
            table, positions, grad, ctx.layout, ctx.features, ctx.needs_input_grad[1])
        return (dtable if ctx.needs_input_grad[0] else None), dpos, None, None

    @staticmethod
    def vmap(info, in_dims, table, positions, layout, features):
        table, positions = _scene_first(in_dims[:2], table, positions)
        return corner_encode_fwd_cuda(table, positions, layout, features), 0


def grid_encode_flat(
    table: torch.Tensor, positions: torch.Tensor, resolutions, table_size: int,
    features: int, mode: str,
) -> torch.Tensor:
    """Twin of the JAX package's ``grid_encode_flat`` without its TPU-only
    arguments: compute is float32, and dPositions is taken whenever
    ``positions`` needs a gradient. positions [P, 3] in [0,1]^3 ->
    [P, L*F], level-major.

    mode="corner": table [L*T, F]; CUDA tensors launch K3/K4
    (``csrc/corner_encode.cu``). mode="cell" (cell v1, F = 2): table
    [L*T, 16]; it is ``cell_encode`` at ``uniform_cell_layout``, whose
    kernels compute what K5/K6 compute."""
    if mode == "cell":
        if features != 2:
            raise ValueError(f"cell mode packs F=2 features a level, got {features}")
        return cell_encode(table, positions, uniform_cell_layout(resolutions, table_size))
    if mode != "corner":
        raise ValueError(f"grid_encode_flat mode must be 'cell' or 'corner', got {mode!r}")
    layout = corner_layout(resolutions, table_size)
    if _device_type(table, positions, "grid_encode_flat") == "cpu":
        return grid_encode_corner_torch(table, positions, layout, features)
    return _CornerEncodeCUDA.apply(table, positions.contiguous(), layout, features)
