"""The port's CUDA segment-SpMM kernel on the card, against its plain
version (kernels/ref.py): within rtol = atol = 1e-5 in f32 (6e-2 in bf16),
bitwise equal from launch to launch, and refusing what it cannot do.

Every test here needs a CUDA card and skips without one.  The file imports
neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import segment_spmm as spmm  # noqa: E402

# N, m, d, e, padding edges per segment, segment 0 without edges
CASES = [
    (1, 16, 8, 5, 0, False),          # N = 1
    (5, 48, 40, 130, 20, False),      # padding edges
    (3, 37, 130, 300, 0, False),      # m not a power of two, d > 128
    (4, 24, 12, 64, 8, True),         # a zero-edge segment
    (8, 64, 64, 512, 100, False),     # the catch-all serving bucket
    (4, 1024, 128, 8192, 512, False),  # the kernel's stated limits
]


def _inputs(N, m, d, e, seed, n_pad=0, empty_seg=False):
    """Random edges with duplicates; the last ``n_pad`` edges of every
    segment are padding, (0, 0) with w = 0; ``empty_seg`` makes segment 0
    all padding."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, m, d)).astype(np.float32)
    src = rng.integers(0, m, (N, e)).astype(np.int32)
    dst = rng.integers(0, m, (N, e)).astype(np.int32)
    if e:
        dst[:, 1] = dst[:, 0]
        src[:, 1] = src[:, 0]
    w = (rng.uniform(0, 1, (N, e)) * (rng.uniform(size=(N, e)) > 0.3)
         ).astype(np.float32)
    if n_pad:
        src[:, e - n_pad:] = dst[:, e - n_pad:] = 0
        w[:, e - n_pad:] = 0.0
    if empty_seg:
        src[0] = dst[0] = 0
        w[0] = 0.0
    return h, src, dst, w


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("N,m,d,e,n_pad,empty_seg", CASES)
def test_kernel_matches_plain_and_is_deterministic(cuda, N, m, d, e, n_pad,
                                                   empty_seg):
    args = [torch.from_numpy(a).to(cuda) for a in
            _inputs(N, m, d, e, seed=e, n_pad=n_pad, empty_seg=empty_seg)]
    ops.reset_kernel_launches()
    a = spmm.segment_spmm_batched(*args)
    b = spmm.segment_spmm_batched(*args)
    torch.cuda.synchronize()
    assert ops.kernel_launches()["segment_spmm_batched"] == 2
    assert torch.equal(a, b)
    torch.testing.assert_close(a, ref.segment_spmm_batched_ref(*args),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_kernel_bf16(cuda):
    h, src, dst, w = (torch.from_numpy(a).to(cuda) for a in
                      _inputs(4, 32, 64, 257, seed=11, n_pad=7))
    got = spmm.segment_spmm_batched(h.bfloat16(), src, dst, w)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(),
                               ref.segment_spmm_batched_ref(h, src, dst, w),
                               rtol=6e-2, atol=6e-2)


@pytest.mark.gpu
def test_kernel_refuses_grad_and_oversize(cuda):
    h, src, dst, w = (torch.from_numpy(a).to(cuda) for a in
                      _inputs(2, 8, 4, 6, seed=0))
    with pytest.raises(NotImplementedError, match="training slice"):
        spmm.segment_spmm_batched(h.requires_grad_(), src, dst, w)
    big = torch.zeros(1, 4, 4, device=cuda)
    idx = torch.zeros(1, 70000, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        spmm.segment_spmm_batched(big, idx, idx, idx.float())


@pytest.mark.gpu
def test_kernel_inf_gives_nan_like_plain(cuda):
    """0 · inf on a padding edge stays in the sum, as in the reference."""
    h, src, dst, w = (torch.from_numpy(a).to(cuda) for a in
                      _inputs(2, 8, 4, 6, seed=2, n_pad=2))
    h[0, 0, 1] = float("inf")
    got = spmm.segment_spmm_batched(h, src, dst, w)
    want = ref.segment_spmm_batched_ref(h, src, dst, w)
    assert torch.equal(got.isnan(), want.isnan()) and bool(got[0, 0, 1].isnan())


@pytest.mark.gpu
def test_encode_kernel_path_matches_plain_on_card(cuda):
    """One bucket batch through the GNN: one launch per message-passing
    layer, equal to the plain encoder on the card."""
    from repro_torch.graphs.batching import segment_dataset
    from repro_torch.graphs.data import make_malnet_like
    from repro_torch.graphs.gnn import GNNConfig, encode_segments, gnn_init
    from repro_torch.serve.engine import to_device

    ds = segment_dataset(make_malnet_like(n_graphs=2, seed=1), max_seg_nodes=64)
    si = {k: v.reshape((-1,) + v.shape[2:])
          for k, v in ds.seg_inputs(np.arange(ds.n)).items()}
    si = to_device(si, cuda)
    for backbone in ("gcn", "sage"):
        cfg = GNNConfig(backbone=backbone, use_kernels=True)
        params = gnn_init(cfg, torch.Generator().manual_seed(0), cuda)
        ops.reset_kernel_launches()
        with torch.no_grad():
            got = encode_segments(params, cfg, si)
            want = encode_segments(params, GNNConfig(backbone=backbone), si)
        assert ops.kernel_launches()["segment_spmm_batched"] == cfg.n_mp
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
