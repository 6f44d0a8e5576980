"""The port's CUDA kernels on the card (the segment SpMM, its backward,
sed_pool / sed_pool_aged, and the six pack / unpack kernels of the
compressed exchange), against their plain versions (kernels/ref.py):
within rtol = atol = 1e-5 in f32 forward (6e-2 in bf16) and 1e-4 for
gradients, the pack and unpack kernels BITWISE, bitwise equal from launch
to launch, refusing what they cannot do; and a few GST train steps through
them, single-device and distributed, against the plain path.

Every test here needs a CUDA card and skips without one.  The file imports
neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import sed_pool as sp  # noqa: E402
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
def test_kernel_refuses_oversize(cuda):
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


# ---------------------------------------------------------------------------
# the SpMM backward
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("N,m,d,e,n_pad,empty_seg", CASES[:5] + [
    (8, 64, 64, 382, 100, False), (160, 64, 64, 382, 100, False)])
def test_backward_matches_plain_autograd(cuda, N, m, d, e, n_pad, empty_seg):
    h, src, dst, w = (torch.from_numpy(a).to(cuda) for a in
                      _inputs(N, m, d, e, seed=e + 1, n_pad=n_pad,
                              empty_seg=empty_seg))
    g = torch.randn(N, m, d, generator=torch.Generator().manual_seed(e)
                    ).to(cuda)
    grads = []
    for fn in (spmm.segment_spmm_batched, ref.segment_spmm_batched_ref):
        hh, ww = h.clone().requires_grad_(), w.clone().requires_grad_()
        torch.sum(fn(hh, src, dst, ww) * g).backward()
        grads.append((hh.grad, ww.grad))
    (dh, dw), (dh_ref, dw_ref) = grads
    torch.testing.assert_close(dh, dh_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dw, dw_ref, rtol=1e-4, atol=1e-4)
    ops.reset_kernel_launches()
    a = spmm.segment_spmm_batched_transpose(g, src, dst, w)
    b = spmm.segment_spmm_batched_transpose(g, src, dst, w)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(a, dh)
    assert ops.kernel_launches()["segment_spmm_batched_bwd"] == 2


# ---------------------------------------------------------------------------
# sed_pool and sed_pool_aged
# ---------------------------------------------------------------------------


def _sed_inputs(B, J, d, seed, cuda):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, J, d)).astype(np.float32)
    n_valid = rng.integers(1, J + 1, B)
    valid = (np.arange(J)[None, :] < n_valid[:, None]).astype(np.float32)
    fresh = np.zeros((B, J), np.float32)
    fresh[np.arange(B), rng.integers(0, n_valid)] = 1.0
    drop = (rng.uniform(size=(B, J)) > 0.5).astype(np.float32)
    drop[0] = 1.0                          # every stale segment dropped
    ages = rng.integers(0, 30, (B, J)).astype(np.float32)
    return [torch.from_numpy(a).to(cuda) for a in (h, valid, fresh, drop, ages)]


@pytest.mark.gpu
@pytest.mark.parametrize("decay", [0.0, 0.05])
@pytest.mark.parametrize("agg", ["mean", "sum"])
@pytest.mark.parametrize("B,J,d", [(8, 20, 64), (8, 16, 1), (5, 7, 130),
                                   (1024, 64, 256)])
def test_sed_pool_matches_plain(cuda, B, J, d, agg, decay):
    h, valid, fresh, drop, ages = _sed_inputs(B, J, d, seed=B + J + d,
                                              cuda=cuda)
    kw = dict(keep_prob=0.5, num_sampled=1, agg=agg, ages=ages, decay=decay)
    g = torch.randn(B, d, generator=torch.Generator().manual_seed(d)).to(cuda)
    ops.reset_kernel_launches()
    hh = h.clone().requires_grad_()
    a = sp.sed_pool(hh, valid, fresh, drop, **kw)
    torch.sum(a * g).backward()
    b = sp.sed_pool(h, valid, fresh, drop, **kw)
    key = "sed_pool_aged" if decay > 0 else "sed_pool"
    assert ops.kernel_launches()[key] == 2
    assert torch.equal(a.detach(), b)
    hr = h.clone().requires_grad_()
    want = ref.sed_pool_ref(hr, valid, fresh, drop, 0.5, 1, agg, ages, decay)
    torch.sum(want * g).backward()
    torch.testing.assert_close(b, want.detach(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(hh.grad, hr.grad, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_sed_pool_bf16(cuda):
    h, valid, fresh, drop, _ = _sed_inputs(8, 20, 64, seed=1, cuda=cuda)
    got = sp.sed_pool(h.bfloat16(), valid, fresh, drop, keep_prob=0.5,
                      num_sampled=1)
    assert got.dtype == torch.bfloat16
    want = ref.sed_pool_ref(h, valid, fresh, drop, 0.5, 1)
    torch.testing.assert_close(got.float(), want, rtol=6e-2, atol=6e-2)


# ---------------------------------------------------------------------------
# GST train steps through the kernels
# ---------------------------------------------------------------------------


def _train_setup(cuda, backbone="sage", dataset="malnet", sed_decay=0.0):
    from repro_torch.core import gst as G
    from repro_torch.core.embedding_table import init_table
    from repro_torch.graphs.batching import batch_iterator, segment_dataset
    from repro_torch.graphs.data import make_malnet_like, make_tpugraphs_like
    from repro_torch.graphs.gnn import GNNConfig, gnn_init, make_encode_fn
    from repro_torch.optim import make_optimizer
    from repro_torch.serve.engine import to_device

    make = make_malnet_like if dataset == "malnet" else make_tpugraphs_like
    head_mode, loss_kind, agg, n_out = (
        ("mlp", "ce", "mean", 5) if dataset == "malnet"
        else ("segment_sum", "pairwise_hinge", "sum", 1))
    ds = segment_dataset(make(n_graphs=16, seed=0), max_seg_nodes=64)
    tups = list(batch_iterator(ds, 8, rng=np.random.default_rng(0)))
    batches = [G.GSTBatch(to_device(t[0], cuda), to_device(
        {"v": t[1]}, cuda)["v"], torch.from_numpy(t[2].astype(np.int64)).to(
        cuda), torch.from_numpy(np.asarray(t[3])).to(cuda)) for t in tups]
    runs = {}
    for use_kernels in (True, False):
        cfg = GNNConfig(backbone=backbone, use_kernels=use_kernels)
        gen = torch.Generator().manual_seed(0)
        bb = gnn_init(cfg, gen, cuda)
        head = G.head_init(cfg.hidden, n_out, head_mode, gen, cuda)
        opt = make_optimizer("adam", lr=5e-3)
        st = G.TrainState(bb, head, None,
                          init_table(ds.n, ds.j_max, cfg.hidden, device=cuda),
                          0)
        st = st._replace(opt_state=opt.init(G.train_params(st)))
        step = G.make_train_step(
            make_encode_fn(cfg), opt, G.VARIANTS["gst_efd"],
            head_mode=head_mode, loss_kind=loss_kind, agg=agg,
            use_kernels=use_kernels, sed_decay=sed_decay)
        runs[use_kernels] = (st, step, cfg)
    return batches, runs


@pytest.mark.gpu
@pytest.mark.parametrize("backbone,dataset,decay", [
    ("sage", "malnet", 0.0), ("gcn", "tpugraphs", 0.0),
    ("sage", "malnet", 0.05)])
def test_train_steps_kernel_path_matches_plain(cuda, backbone, dataset,
                                               decay):
    """Per step: n_mp SpMM forward and n_mp backward launches and one
    sed_pool (or sed_pool_aged) launch; loss, gradients, parameters and
    table equal to the plain path on the card given the same draws, each
    step from the same state (``repro_torch.core.step_parity``).  The third
    step shows the first batch again, so stale table entries (and their
    ages) weigh in Eq. 1."""
    from repro_torch.core.step_parity import kernel_step_parity

    batches, runs = _train_setup(cuda, backbone, dataset, decay)
    (st_k, step_k, cfg), (st_p, step_p, _) = runs[True], runs[False]
    pool = "sed_pool_aged" if decay > 0 else "sed_pool"
    _, n_stale = kernel_step_parity(
        (st_k, step_k), (st_p, step_p), [batches[0], batches[1], batches[0]],
        torch.Generator().manual_seed(1),
        {"segment_spmm_batched": cfg.n_mp,
         "segment_spmm_batched_bwd": cfg.n_mp,
         "sed_pool": int(pool == "sed_pool"),
         "sed_pool_aged": int(pool == "sed_pool_aged")})
    assert n_stale > 0


# ---------------------------------------------------------------------------
# the compressed exchange's pack and unpack kernels
# ---------------------------------------------------------------------------


def _quant_inputs(R, N, seed, cuda):
    """Random rows with a zero row, ±0, values on the nearest-even ties of
    both grids, and a row whose amax is 127 (scale exactly 1)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(R, N)) * 3.0).astype(np.float32)
    x[0] = 0.0
    if R > 1:
        ties = np.asarray([-0.0, 1.0 + 2.0 ** -8, 63.5, -0.5, 2.5, 1e-30],
                          np.float32)
        x[1, :min(N, 6)] = ties[:min(N, 6)]
        x[1, -1] = 127.0
    bits = rng.integers(0, 2 ** 32, (R, N), dtype=np.uint64).astype(
        np.uint32).view(np.int32)
    return torch.from_numpy(x).to(cuda), torch.from_numpy(bits).to(cuda)


def _same_bits(a, b):
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("R,N", [(1, 4), (2, 64), (3, 33), (8, 1280),
                                 (16, 1000), (512, 1280)])
def test_quant_kernels_bitwise_plain(cuda, R, N, dtype, stochastic):
    from repro_torch.kernels import quant as Q

    x, bits = _quant_inputs(R, N, seed=R + N, cuda=cuda)
    bits = bits if stochastic else None
    ops.reset_kernel_launches()
    a = Q.quantize_rows(x, dtype, bits)
    b = Q.quantize_rows(x, dtype, bits)
    want = ref.quantize_rows_ref(x, dtype, bits)
    back_a = Q.dequantize_rows(a, dtype)
    back_b = Q.dequantize_rows(b, dtype)
    torch.cuda.synchronize()
    pack = {("bf16", False): Q.PACK_BF16_DET, ("bf16", True): Q.PACK_BF16,
            ("int8", False): Q.PACK_INT8_DET,
            ("int8", True): Q.PACK_INT8}[(dtype, stochastic)]
    unpack = Q.UNPACK_BF16 if dtype == "bf16" else Q.UNPACK_INT8
    assert {k: v for k, v in ops.kernel_launches().items() if v} == {
        pack: 2, unpack: 2}
    for pa, pb, pw in zip(a, b, want):
        assert pa.dtype == pw.dtype and _same_bits(pa, pb)
        assert _same_bits(pa, pw)
    assert _same_bits(back_a, back_b)
    assert _same_bits(back_a, ref.dequantize_rows_ref(want, dtype))


@pytest.mark.gpu
def test_quant_kernels_refuse_what_they_cannot_do(cuda):
    from repro_torch.kernels import quant as Q

    x, bits = _quant_inputs(4, 64, seed=0, cuda=cuda)
    with pytest.raises(ValueError, match="rand_bits is on"):
        Q.quantize_rows(x, "int8", bits.cpu())
    with pytest.raises(TypeError, match="x must be"):
        Q.quantize_rows(x.double(), "bf16")
    with pytest.raises(TypeError, match="rand_bits must be"):
        Q.quantize_rows(x, "bf16", bits.long())
    with pytest.raises(ValueError, match="contiguous"):
        Q.quantize_rows(x.t(), "int8")
    v, s = Q.quantize_rows(x, "int8")
    with pytest.raises(ValueError, match="scale is on"):
        Q.dequantize_rows((v, s.cpu()), "int8")
    with pytest.raises(TypeError, match="values must be"):
        Q.dequantize_rows((v.float(),), "bf16")
    with pytest.raises(ValueError, match="contiguous"):
        Q.dequantize_rows((v.t(), s), "int8")


@pytest.mark.gpu
def test_dist_steps_kernel_path_matches_plain(cuda):
    """Three distributed train steps, 2 shards as threads on the card, ring
    with int8 payloads (repro_torch.core.step_parity.dist_step_parity):
    per step the SpMM, sed_pool and the codec's launches on every shard,
    loss, gradients, parameters and table shards equal to the plain path
    given the same draws and bits, with a stale segment kept."""
    from repro_torch.core.step_parity import dist_step_parity
    from repro_torch.dist.pipeline import _assemble
    from repro_torch.kernels import quant as Q
    from repro_torch.launch.train_dist import build_parser, setup

    runs = []
    for flag in ("--use-kernels", "--no-use-kernels"):
        s = setup(build_parser().parse_args([
            "--device", "cuda", "--devices", "2", "--exchange", "ring",
            "--payload-dtype", "int8", "--n-graphs", "16", "--hidden", "64",
            "--max-seg-nodes", "64", flag]))
        runs.append((s.ctx, s.states, s.step))
    ids = s.train_scheds[0]
    D, n_mp = 2, 2
    want = {"segment_spmm_batched": D * n_mp,
            "segment_spmm_batched_bwd": D * n_mp, "sed_pool": D,
            Q.PACK_INT8_DET: D * D, Q.UNPACK_INT8: D + D * D,
            Q.PACK_INT8: D}
    _, n_stale = dist_step_parity(
        runs[0], runs[1], [_assemble(s.ds, i) for i in (ids[0], ids[1],
                                                         ids[0])],
        torch.Generator().manual_seed(1), want)
    assert n_stale > 0
