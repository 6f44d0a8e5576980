"""Pack and unpack rows for the compressed exchange wire format.

Counterpart of ``src/repro/kernels/quant.py``: the payloads of the
distributed table exchange (lookup answers, write-back rows) travel as
``bf16`` values or ``int8`` values with one f32 scale per leading row (see
``ref.quantize_rows_ref`` for the arithmetic).  The read path rounds to
nearest even; the write path rounds stochastically with caller-drawn
random bits, so two implementations given the same bits agree bit for bit.

The wrapper of the hand-written CUDA kernels in ``csrc/quant.cu``, which
replace the six TPU kernels of ``src/repro/kernels/quant.py`` (``:139``,
``:143``, ``:147``, ``:153``, ``:159``, ``:163``); see the source's note
for the design and its bound.

Device rule: a CPU tensor goes to the plain version (``ref.py``); a CUDA
tensor launches the kernel or raises.  Nothing falls back.  ``LAUNCHES``
counts each kernel's launches, one per launch.  ``plan_pack_int8`` and
``plan_unpack_int8`` pick the int8 kernels' geometry.  The random bits are an
int32 tensor holding the uint32 bit pattern (torch has no usable uint32
arithmetic); the kernel reads them as a raw 32-bit buffer.  Nothing here
is differentiated: the exchange packs detached embeddings.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.counts import LaunchCounts
from repro_torch.kernels.segment_spmm import _sms

PAYLOAD_DTYPES = ("f32", "bf16", "int8")

PACK_BF16 = "quant_pack_bf16"           # stochastic (write path)
PACK_BF16_DET = "quant_pack_bf16_det"   # nearest even (read path)
PACK_INT8 = "quant_pack_int8"
PACK_INT8_DET = "quant_pack_int8_det"
UNPACK_BF16 = "quant_unpack_bf16"
UNPACK_INT8 = "quant_unpack_int8"
LAUNCHES = LaunchCounts((PACK_BF16, PACK_BF16_DET, PACK_INT8, PACK_INT8_DET,
                         UNPACK_BF16, UNPACK_INT8))

ROW_WARPS = 8                    # the int8 packs' block: 8 warps
VECS_PER_LANE = (2, 4, 8, 16)    # its compiled register arrays, in float4
# the widest row whose float4 all stay in registers (8 warps of 16 each);
# a wider row's further float4 are read twice
REGISTER_N = 4 * 32 * ROW_WARPS * VECS_PER_LANE[-1]


@dataclasses.dataclass(frozen=True)
class Int8Plan:
    """The int8 packs' geometry: ``warps_per_row`` warps a row
    (``ROW_WARPS // warps_per_row`` rows a block), each thread keeping
    ``vecs_per_lane`` float4 of x (and, when stochastic, as many 16-byte
    words of random bits) in registers; a row with more float4 than its
    threads keep (wider than REGISTER_N) reads x's rest twice and its
    bits' rest once."""
    warps_per_row: int
    vecs_per_lane: int


def plan_pack_int8(R: int, N: int, sms: int = 132) -> Int8Plan:
    """The fewest warps a row (at most 8) whose threads hold its N // 4
    float4 in at most 8 registers' worth each (16 at 8 warps); then twice
    as many warps a row, while the rows' warps stay within two fills of the
    card (64 an SM), until a thread holds at most 2 float4: where few rows
    arrive, each row's chain of loads, reduction and stores is cut across
    more threads.  The register array is the smallest compiled one that
    holds a thread's share: 8 warps a row of 2 at 2 x 1280, 2 warps of 8
    at 8192 x 1280."""
    nvec = N // 4
    W = 1
    while W < ROW_WARPS and nvec > 32 * W * 8:
        W *= 2
    while W < ROW_WARPS and R * W * 2 <= 128 * sms and -(-nvec // (32 * W)) > 2:
        W *= 2
    share = -(-nvec // (32 * W))
    K = next((k for k in VECS_PER_LANE if k >= share), VECS_PER_LANE[-1])
    return Int8Plan(W, K)


UNPACK_GROUPS = (1, 2, 4, 8, 16)   # the int8 unpack's compiled words a thread


def plan_unpack_int8(R: int, N: int, sms: int = 132) -> int:
    """Words of 4 int8 a thread of the int8 unpack (a warp takes 128 of
    them a word): the most that still give the card 4 warps an SM."""
    n = R * N
    return max((g for g in UNPACK_GROUPS if n >= 128 * g * 4 * sms),
               default=UNPACK_GROUPS[0])


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels._build import load

    lib = load("quant")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.quant_pack_bf16.argtypes = [p, p, p, i, i, p]
        lib.quant_pack_int8.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.quant_unpack_bf16.argtypes = [p, p, i, i, p]
        lib.quant_unpack_int8.argtypes = [p, p, p, i, i, i, p]
        for fn in (lib.quant_pack_bf16, lib.quant_pack_int8,
                   lib.quant_unpack_bf16, lib.quant_unpack_int8):
            fn.restype = i
        lib.quant_error_string.argtypes = [i]
        lib.quant_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, not {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, not {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, want {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _run(t: torch.Tensor, fn, *args) -> None:
    """Call ``fn(*args, stream)`` on ``t``'s device and raise on an error."""
    lib = _lib()
    with torch.cuda.device(t.device):
        err = fn(*args, torch.cuda.current_stream(t.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: "
                           + lib.quant_error_string(err).decode())


def _on_cuda(name: str, t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {t.device}")
    return True


def quantize_rows(x: torch.Tensor, dtype: str, rand_bits=None):
    """Pack f32 rows x (R, ...) into the wire parts of ``dtype``: (values
    bf16,) or (values int8, scale (R,) f32).  ``rand_bits`` (int32 of x's
    shape) rounds stochastically, None to nearest even.  One launch on
    CUDA (none for an empty x); the plain version on the CPU."""
    if dtype not in ("bf16", "int8"):
        raise ValueError(f"quantize dtype {dtype!r} not in ('bf16', 'int8')")
    if not _on_cuda("quantize_rows", x):
        return ref.quantize_rows_ref(x, dtype, rand_bits)
    shape = tuple(x.shape)
    _check("x", x, torch.float32, shape, x.device)
    if rand_bits is not None:
        _check("rand_bits", rand_bits, torch.int32, shape, x.device)
    R = shape[0] if shape else 1
    N = x.numel() // R if R else 0
    bits_ptr = None if rand_bits is None else rand_bits.data_ptr()
    lib = _lib()
    if dtype == "bf16":
        out = torch.empty(shape, dtype=torch.bfloat16, device=x.device)
        if x.numel():
            _run(x, lib.quant_pack_bf16, x.data_ptr(), bits_ptr,
                 out.data_ptr(), R, N)
            LAUNCHES.add(PACK_BF16 if rand_bits is not None else PACK_BF16_DET)
        return (out,)
    out = torch.empty(shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((R,), dtype=torch.float32, device=x.device)
    if x.numel():
        g = plan_pack_int8(R, N, _sms(x.device.index or 0))
        _run(x, lib.quant_pack_int8, x.data_ptr(), bits_ptr, out.data_ptr(),
             scale.data_ptr(), R, N, g.warps_per_row, g.vecs_per_lane)
        LAUNCHES.add(PACK_INT8 if rand_bits is not None else PACK_INT8_DET)
    return out, scale


def dequantize_rows(parts, dtype: str) -> torch.Tensor:
    """Unpack wire parts back to f32 rows (inverse of ``quantize_rows``).
    One launch on CUDA (none for an empty buffer); the plain version on the
    CPU."""
    parts = tuple(parts)
    if dtype not in ("bf16", "int8"):
        raise ValueError(f"dequantize dtype {dtype!r} not in ('bf16', 'int8')")
    v = parts[0]
    if not _on_cuda("dequantize_rows", v):
        return ref.dequantize_rows_ref(parts, dtype)
    shape = tuple(v.shape)
    R = shape[0] if shape else 1
    N = v.numel() // R if R else 0
    out = torch.empty(shape, dtype=torch.float32, device=v.device)
    lib = _lib()
    if dtype == "bf16":
        _check("values", v, torch.bfloat16, shape, v.device)
        if v.numel():
            _run(v, lib.quant_unpack_bf16, v.data_ptr(), out.data_ptr(), R, N)
            LAUNCHES.add(UNPACK_BF16)
        return out
    _check("values", v, torch.int8, shape, v.device)
    _check("scale", parts[1], torch.float32, (R,), v.device)
    if v.numel():
        _run(v, lib.quant_unpack_int8, v.data_ptr(), parts[1].data_ptr(),
             out.data_ptr(), R, N, plan_unpack_int8(R, N, _sms(v.device.index or 0)))
        LAUNCHES.add(UNPACK_INT8)
    return out
