"""SpMM inputs that stress the segment SpMM kernel's design (a sort shared by
all warps, weight-0 repeats dropped, rows tiled across blocks, vector
loads), made with numpy from a seed.  One generator for the CPU tests
against the JAX package (tests/test_torch_spmm.py) and the card's tests
(tests/test_torch_kernels_gpu.py); it imports neither torch nor JAX."""
import numpy as np

# name -> (N, m, d, e, options of ``make``)
CASES = {
    # one destination with 300 in-edges (more than a block's 256 threads)
    "hub": (2, 48, 64, 600, {"hub": 300}),
    # weight-0 repeated (src, dst) pairs away from node 0, between real edges
    "zero_weight_repeats": (3, 40, 40, 300, {"zero_repeats": True, "n_pad": 30}),
    # segment 0 is padding only
    "padding_only_segment": (3, 33, 64, 128, {"n_pad": 20, "empty_seg": True}),
    # src or dst outside [0, m): skipped
    "out_of_range": (2, 37, 64, 200, {"out_of_range": True, "n_pad": 10}),
    # m not a multiple of 32, several row tiles
    "m_45": (4, 45, 128, 333, {"n_pad": 40}),
    "d_1": (3, 20, 1, 90, {"n_pad": 10}),
    "d_40": (5, 48, 40, 130, {"n_pad": 20}),
    "d_64": (8, 64, 64, 512, {"n_pad": 128}),
    "d_128": (2, 100, 128, 700, {"n_pad": 100}),
    # inf in h at node 7, reached only by a weight-0 edge into node 9
    "inf_under_zero_weight": (2, 24, 64, 100, {"n_pad": 10, "inf": True}),
}
# the cases whose h is also given in bf16
BF16_CASES = ("hub", "zero_weight_repeats", "d_40", "d_64", "d_128")


def make(N, m, d, e, seed, n_pad=0, hub=0, zero_repeats=False,
         empty_seg=False, out_of_range=False, inf=False):
    """(h f32 (N, m, d), src, dst int32 (N, e), w f32 (N, e)).  Random edges
    with a repeated edge; the last ``n_pad`` edges of every segment are
    padding, (0, 0) with w = 0 as graphs/batching.py pads."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, m, d)).astype(np.float32)
    src = rng.integers(0, m, (N, e)).astype(np.int32)
    dst = rng.integers(0, m, (N, e)).astype(np.int32)
    w = rng.uniform(0.1, 1.0, (N, e)).astype(np.float32)
    w[rng.uniform(size=(N, e)) < 0.2] = 0.0      # some real edges of weight 0
    src[:, 1], dst[:, 1] = src[:, 0], dst[:, 0]
    if hub:
        dst[:, 2:2 + hub] = m // 2
    if zero_repeats:
        for k in range(5, e - n_pad - 3, 9):
            src[:, k:k + 3] = src[:, k:k + 1]
            dst[:, k:k + 3] = dst[:, k:k + 1]
            w[:, k:k + 3] = 0.0
    if out_of_range:
        src[:, 3], dst[:, 4] = m, -1
        src[:, 6], dst[:, 7] = -5, m + 3
    if n_pad:
        src[:, e - n_pad:] = dst[:, e - n_pad:] = 0
        w[:, e - n_pad:] = 0.0
    if empty_seg:
        src[0] = dst[0] = 0
        w[0] = 0.0
    if inf:
        h[1, 7, 3] = np.inf
        src[1, src[1] == 7] = 8                   # no weighted edge reads node 7
        src[1, 20], dst[1, 20], w[1, 20] = 7, 9, 0.0
    return h, src, dst, w


def case(name, seed=0):
    N, m, d, e, opts = CASES[name]
    return make(N, m, d, e, seed=seed + N * m + e, **opts)
