"""Wire-format inputs with subnormals, and random bits on the stochastic
int8 rounding's boundary, made with numpy from a seed: one generator for
the CPU tests against the JAX package (tests/test_torch_quant.py,
tests/test_torch_quant_plan.py), the card's tests
(tests/test_torch_kernels_gpu.py) and chip_smoke.py's kernel phase.  It
imports neither torch nor JAX.

The JAX package's int8 arithmetic is XLA's on the CPU, which reads a
subnormal input as zero and flushes a subnormal result; its bf16 paths are
bit operations and keep subnormals.  These rows tell the two apart."""
import numpy as np

TINY = float(np.finfo(np.float32).tiny)      # FLT_MIN, 2^-126

# rows padded with zeros to the case's width (zeros change no amax)
ROWS = (
    # all subnormal: amax reads as 0, so scale 0 and values 0
    (1e-39, -5e-40, 2e-40, 0.0),
    # scale 1e-38 is under FLT_MIN: flushed to 0, the row divided by 1
    (1.27e-36, 9e-39, -9e-39, 6e-39),
    # scale 1e-37 (normal): 1e-39 reads as 0 -> (127, 1, 0, 0)
    (1.27e-35, 9e-38, 1e-39, 0.0),
    # scale just above FLT_MIN: 1.1e-38 / scale is 0.93 unflushed, 0 flushed
    (127 * TINY * 1.01, 1.1e-38, -1.1e-38, 5e-39, 1e-37, -2e-37),
    # a subnormal quotient (1e-12 / 7.9e27): 1 under bits >> 8 == 0 unless
    # flushed
    (1e30, 1e-12, -1e-12, 3e-39),
)
# the (5, -3) unpack at a subnormal scale of either sign: (0, -0), (-0, 0)
UNPACK_VALUES = (5, -3)
UNPACK_SCALES = (1e-40, -1e-40)


def subnormal_rows(n: int = 8, seed: int = 0):
    """(x (R, n) f32, bits (R, n) uint32 whose high 24 bits are zero): the
    rows above, then random rows of amax 1.5·127·FLT_MIN (a scale just
    above FLT_MIN), 127e-30 (a normal scale) and 0.5·127·FLT_MIN (a scale
    flushed to 0), each with half its elements subnormal of both signs."""
    if n < max(map(len, ROWS)):
        raise ValueError(f"n {n} is narrower than the widest row")
    rng = np.random.default_rng(seed)
    x = np.zeros((len(ROWS) + 3, n), np.float32)
    for i, row in enumerate(ROWS):
        x[i, :len(row)] = row
    for i, amax in enumerate((1.5 * 127 * TINY, 127e-30, 0.5 * 127 * TINY)):
        row = rng.uniform(-1.0, 1.0, n) * amax
        sub = rng.random(n) < 0.5
        row[sub] = rng.uniform(-TINY, TINY, int(sub.sum()))
        row[0] = amax
        x[len(ROWS) + i] = row.astype(np.float32)
    bits = rng.integers(0, 256, x.shape, dtype=np.uint64).astype(np.uint32)
    return x, bits


def subnormal_unpack():
    """(v (2, 2) int8, scale (2,) f32): (5, -3) at scales ±1e-40."""
    v = np.tile(np.asarray(UNPACK_VALUES, np.int8), (len(UNPACK_SCALES), 1))
    return v, np.asarray(UNPACK_SCALES, np.float32)


def boundary_bits(x, delta: int, seed: int = 0):
    """uint32 bits of x's shape on the stochastic int8 rounding's boundary:
    bits >> 8 = floor((v - floor(v)) * 2^24) + delta (clipped to [0,
    2^24)), v = x / scale in f32 as the wire format computes it (x finite,
    its rows' scales normal), the low 8 bits random.  The rounding adds 1
    where (bits >> 8) * 2^-24 < v - floor(v): at delta -1 an element with
    v - floor(v) > 0 rounds up, at +1 down, and at 0 the result turns on
    the quotient's last bit."""
    x = np.asarray(x, np.float32)
    scale = np.abs(x).max(axis=1, keepdims=True) * np.float32(1.0 / 127.0)
    v = x / np.where(scale > 0, scale, np.float32(1.0))
    frac = v - np.floor(v)
    k = np.floor(frac.astype(np.float64) * 2.0 ** 24).astype(np.int64) + delta
    k = np.clip(k, 0, 2 ** 24 - 1).astype(np.uint32)
    low = np.random.default_rng(seed).integers(0, 256, x.shape, dtype=np.uint64)
    return (k << np.uint32(8)) | low.astype(np.uint32)
