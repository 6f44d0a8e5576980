"""Batched weighted segment SpMM: the GNN's neighbor aggregation.

    out[n, v] = Σ_{e: dst[n,e]=v} w[n,e] · h[n, src[n,e]]

The wrapper of the hand-written CUDA kernel ``csrc/segment_spmm.cu``, which
replaces the TPU kernel ``src/repro/kernels/segment_spmm.py::
_spmm_batched_kernel`` (see the source's note for the design and its bound);
``plan`` picks each launch's geometry.  An edge whose src or dst lies
outside [0, m) adds nothing, on both devices, as in the reference's Pallas
kernel.

Device rule: a CPU tensor goes to the plain version (``ref.py``); a CUDA
tensor launches the kernel or raises.  Nothing falls back.  ``LAUNCHES``
counts the kernel's launches, one per launch and under the key of the pass
that made it, so a run can show that its main path went through the kernel.

Backward (``_SpmmBatched``, the counterpart of the ``custom_vjp`` at
``src/repro/kernels/segment_spmm.py:128-151``): the transpose of the
weighted scatter-add is the same SpMM with src and dst swapped,

    ∂L/∂h[n, u] = Σ_{e: src_e = u} w_e · g[n, dst_e]

so dh is one more launch of the same kernel with the roles exchanged
(counted under ``segment_spmm_batched_bwd``), and dw[n, e] =
⟨g[n, dst_e], h[n, src_e]⟩ is a gather and a product in plain torch, as
the reference computes it in jnp outside Pallas (``ref.take_rows``: its
``take_along_axis`` reads NaN for an index past m).  The Function runs on
both devices; on the CPU its two SpMMs are the plain version.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.counts import LaunchCounts

KERNEL = "segment_spmm_batched"
KERNEL_BWD = "segment_spmm_batched_bwd"
LAUNCHES = LaunchCounts((KERNEL, KERNEL_BWD))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


THREADS = 256                 # a block: 8 warps
WARPS = THREADS // 32
MAX_TILE_ROWS = THREADS       # the block's scan gives one row to a thread


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels._build import load

    lib = load("segment_spmm")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.segment_spmm_batched_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                                 i, i, i, p]
        lib.segment_spmm_batched_fwd.restype = i
        lib.segment_spmm_smem_limit.argtypes = [i]
        lib.segment_spmm_smem_limit.restype = i
        lib.segment_spmm_error_string.argtypes = [i]
        lib.segment_spmm_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def smem_bytes(m: int, e: int, tile_rows: int = None) -> int:
    """Shared memory one block needs (``csrc/segment_spmm.cu::smem_bytes``):
    the e sorted (src, w) records of 8 bytes, the (warp chunk, row) counts
    and the rows' starts, for a tile of ``tile_rows`` destination rows (the
    most a block of this m takes by default)."""
    t = min(m, MAX_TILE_ROWS) if tile_rows is None else tile_rows
    return e * 8 + (WARPS * t + t + 1) * 4


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch's geometry: ``vec`` h elements a thread (one load),
    ``tpr`` threads a destination row, ``tile_rows`` rows a block; the grid
    is (N, row tiles, column tiles)."""
    vec: int
    tpr: int
    tile_rows: int
    row_tiles: int
    col_tiles: int


def plan(N: int, m: int, e: int, d: int, itemsize: int, h_addr: int,
         sms: int = 132, smem_per_sm: int = 232448) -> Plan:
    """The widest load (16, 8, 4 or 2 bytes) that divides a row of h and
    h's address; threads a row the next power of two of d / vec, at most
    32; then as many row tiles as fill the card's blocks once (``sms``
    SMs, as many blocks an SM as threads and ``smem_per_sm`` bytes of
    shared memory allow), at least one row per thread group and at most
    256 rows a tile.  Every row tile scans the segment's whole edge list,
    so the tiles stop where the card is full."""
    vec = 1
    for nbytes in (16, 8, 4, 2):
        if nbytes >= itemsize and (d * itemsize) % nbytes == 0 \
                and h_addr % nbytes == 0:
            vec = nbytes // itemsize
            break
    per_row = max(1, -(-d // vec))
    tpr = min(32, 1 << (per_row - 1).bit_length())
    col_tiles = max(1, -(-d // (tpr * vec)))
    groups = WARPS * (32 // tpr)
    per_sm = max(1, min(2048 // THREADS,
                        smem_per_sm // (smem_bytes(m, e) + 1024)))
    want = max(1, (sms * per_sm) // max(1, N * col_tiles))
    tiles = max(-(-m // MAX_TILE_ROWS), min(want, -(-m // groups)), 1)
    tile_rows = max(1, -(-m // tiles))
    return Plan(vec, tpr, tile_rows, -(-m // tile_rows), col_tiles)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(h, src, dst, w):
    if h.dim() != 3 or src.dim() != 2 or src.shape != dst.shape \
            or w.shape != src.shape or src.shape[0] != h.shape[0]:
        raise ValueError(f"want h (N, m, d), src/dst/w (N, e); got h "
                         f"{tuple(h.shape)}, src {tuple(src.shape)}, dst "
                         f"{tuple(dst.shape)}, w {tuple(w.shape)}")
    if h.dtype not in _DTYPES:
        raise TypeError(f"h must be float32 or bfloat16, not {h.dtype}")
    if src.dtype != torch.int32 or dst.dtype != torch.int32:
        raise TypeError(f"src/dst must be int32, not {src.dtype}/{dst.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"w must be float32, not {w.dtype}")
    for name, t in (("h", h), ("src", src), ("dst", dst), ("w", w)):
        if t.device != h.device:
            raise ValueError(f"{name} is on {t.device}, h on {h.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(h, src, dst, w, key: str) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors, counted under ``key``."""
    _check(h, src, dst, w)
    N, m, d = h.shape
    e = src.shape[1]
    out = torch.empty_like(h)
    if out.numel() == 0:
        return out
    lib = _lib()
    dev = h.device.index if h.device.index is not None \
        else torch.cuda.current_device()
    limit = lib.segment_spmm_smem_limit(dev)
    geo = plan(N, m, e, d, h.element_size(), h.data_ptr(), _sms(dev), limit)
    need = smem_bytes(m, e, geo.tile_rows)
    if need > limit:
        raise ValueError(
            f"segment_spmm_batched: e={e} ({geo.tile_rows} rows a block) needs "
            f"{need} bytes of shared memory per block, more than this card's "
            f"{limit}")
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = lib.segment_spmm_batched_fwd(
            h.data_ptr(), src.data_ptr(), dst.data_ptr(), w.data_ptr(),
            out.data_ptr(), N, m, e, d, _DTYPES[h.dtype], geo.vec,
            geo.tpr.bit_length() - 1, geo.tile_rows, stream)
    if err != 0:
        raise RuntimeError("segment_spmm_batched launch failed: "
                           + lib.segment_spmm_error_string(err).decode())
    LAUNCHES.add(key)
    return out


def _spmm(h, src, dst, w, key: str) -> torch.Tensor:
    if h.device.type == "cpu":
        return ref.segment_spmm_batched_ref(h, src, dst, w)
    if h.device.type != "cuda":
        raise ValueError(f"segment_spmm_batched runs on cpu or cuda, not "
                         f"{h.device}")
    return _launch(h, src, dst, w, key)


def segment_spmm_batched_transpose(g: torch.Tensor, src: torch.Tensor,
                                   dst: torch.Tensor,
                                   w: torch.Tensor) -> torch.Tensor:
    """The transposed SpMM, dh[n, u] = Σ_{e: src[n,e]=u} w[n,e] · g[n, dst[n,e]]:
    the forward with src and dst swapped.  On CUDA one launch of the
    kernel, counted under ``segment_spmm_batched_bwd``."""
    return _spmm(g, dst, src, w, KERNEL_BWD)


class _SpmmBatched(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, src, dst, w):
        ctx.save_for_backward(h, src, dst, w)
        return _spmm(h, src, dst, w, KERNEL)

    @staticmethod
    def backward(ctx, g):
        h, src, dst, w = ctx.saved_tensors
        g = g.contiguous().to(h.dtype)
        dh = segment_spmm_batched_transpose(g, src, dst, w).to(h.dtype)
        dw = None
        if ctx.needs_input_grad[3]:
            g_dst, h_src = ref.take_rows(g, dst), ref.take_rows(h, src)
            dw = torch.sum(g_dst.float() * h_src.float(), dim=-1).to(w.dtype)
        return dh, None, None, dw


def segment_spmm_batched(h: torch.Tensor, src: torch.Tensor,
                         dst: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Batched weighted neighbor scatter-add over N padded segments.

    h: (N, m, d) float32/bfloat16; src/dst: (N, e) int32; w: (N, e) float32,
    0 on padding edges.  Summed in f32, returned in h's dtype.  One kernel
    launch for the whole batch on CUDA; the plain version on the CPU.
    Differentiable in h and w (the backward's dh is one more launch).
    """
    return _SpmmBatched.apply(h, src, dst, w)


def segment_spmm(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """out[v] = Σ_{e: dst_e=v} w_e · h[src_e].   h: (m, d); src/dst/w: (e,).

    Single-segment convenience wrapper over the batched kernel (N = 1).
    """
    return segment_spmm_batched(h[None], src[None], dst[None], w[None])[0]
