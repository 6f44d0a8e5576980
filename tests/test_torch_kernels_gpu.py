"""The port's CUDA kernels on the card (the segment SpMM, its backward,
sed_pool / sed_pool_aged, the six pack / unpack kernels of the
compressed exchange, and the sliding-window attention), against their
plain versions (kernels/ref.py): within rtol = atol = 1e-5 in f32 forward
(6e-2 in bf16) and 1e-4 for gradients, the pack and unpack kernels
BITWISE, bitwise equal from launch to launch, refusing what they cannot
do; a few GST train steps through them, single-device and distributed,
against the plain path; the tiered store's migrations on the card against
the device-resident store; and the reduced dense transformer's kernel path
against its plain path.

Every test here needs a CUDA card and skips without one.  The file imports
neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from _spmm_cases import BF16_CASES, CASES as STRESS_CASES, case  # noqa: E402
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


@pytest.mark.gpu
@pytest.mark.parametrize("name,dtype", [(n, "float32") for n in STRESS_CASES]
                         + [(n, "bfloat16") for n in BF16_CASES])
def test_kernel_stress_cases_match_plain(cuda, name, dtype):
    """The cases that stress the kernel's design (tests/_spmm_cases.py):
    forward and transpose within 1e-5 of the plain version (6e-2 in
    bf16), NaN in the same places, two launches bitwise equal."""
    h, src, dst, w = (torch.from_numpy(a).to(cuda) for a in case(name))
    h = h.to(getattr(torch, dtype))
    tol = 1e-5 if dtype == "float32" else 6e-2
    for fn, plain in (
            (spmm.segment_spmm_batched,
             lambda: ref.segment_spmm_batched_ref(h, src, dst, w)),
            (spmm.segment_spmm_batched_transpose,
             lambda: ref.segment_spmm_batched_ref(h, dst, src, w))):
        a, b = fn(h, src, dst, w), fn(h, src, dst, w)
        want = plain()
        torch.cuda.synchronize()
        assert a.dtype == h.dtype and torch.equal(a.isnan(), want.isnan())
        assert _same_bits(a, b)
        torch.testing.assert_close(a.float(), want.float(), rtol=tol, atol=tol,
                                   equal_nan=True)
    if name == "inf_under_zero_weight":
        assert bool(a.isnan().any())


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(STRESS_CASES))
def test_backward_stress_cases_match_plain_path(cuda, name):
    """dh and dw through the autograd Function on the card against the
    same Function on the CPU, where it runs the plain version (dw of an
    out-of-range edge reads NaN or a wrapped row, as the reference's)."""
    grads = []
    for where in (cuda, torch.device("cpu")):
        h, src, dst, w = (torch.from_numpy(a).to(where) for a in case(name, 1))
        g = torch.randn(h.shape, generator=torch.Generator().manual_seed(3)
                        ).to(where)
        hh, ww = h.requires_grad_(), w.requires_grad_()
        torch.sum(spmm.segment_spmm_batched(hh, src, dst, ww) * g).backward()
        grads.append((hh.grad.cpu(), ww.grad.cpu()))
    (dh, dw), (dh_ref, dw_ref) = grads
    torch.testing.assert_close(dh, dh_ref, rtol=1e-4, atol=1e-4,
                               equal_nan=True)
    torch.testing.assert_close(dw, dw_ref, rtol=1e-4, atol=1e-4,
                               equal_nan=True)
    assert torch.equal(dh.isnan(), dh_ref.isnan())
    assert torch.equal(dw.isnan(), dw_ref.isnan())


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
@pytest.mark.parametrize("B,J,d", [
    (8, 20, 64), (8, 16, 1), (5, 7, 130), (1024, 64, 256),
    (1, 1, 1),            # one segment, one column
    (3, 300, 64),         # J longer than one chunk a thread
    (8, 20, 2),           # a row narrower than one 16-byte vector
    (2, 5000, 3),         # J longer than one shared-memory eta tile
])
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
@pytest.mark.parametrize("B,J,d", [(8, 20, 64),
                                   (4, 20, 130)])   # d not a multiple of 8
def test_sed_pool_bf16(cuda, B, J, d):
    h, valid, fresh, drop, _ = _sed_inputs(B, J, d, seed=1, cuda=cuda)
    got = sp.sed_pool(h.bfloat16(), valid, fresh, drop, keep_prob=0.5,
                      num_sampled=1)
    again = sp.sed_pool(h.bfloat16(), valid, fresh, drop, keep_prob=0.5,
                        num_sampled=1)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, again)
    want = ref.sed_pool_ref(h, valid, fresh, drop, 0.5, 1)
    torch.testing.assert_close(got.float(), want, rtol=6e-2, atol=6e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("decay", [0.0, 0.05])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sed_pool_misaligned_h(cuda, dtype, decay):
    """h contiguous but starting one element past a 16-byte boundary: the
    kernel takes narrower loads, and agrees all the same."""
    B, J, d = 8, 20, 64
    h, valid, fresh, drop, ages = _sed_inputs(B, J, d, seed=5, cuda=cuda)
    store = torch.empty(B * J * d + 1, dtype=dtype, device=cuda)
    hm = store[1:].view(B, J, d)
    hm.copy_(h)
    assert hm.is_contiguous() and hm.data_ptr() % 16 != 0
    kw = dict(keep_prob=0.5, num_sampled=1, ages=ages, decay=decay)
    a = sp.sed_pool(hm, valid, fresh, drop, **kw)
    b = sp.sed_pool(hm, valid, fresh, drop, **kw)
    assert torch.equal(a, b)
    want = ref.sed_pool_ref(hm.float(), valid, fresh, drop, 0.5, 1, "mean",
                            ages, decay)
    tol = 1e-5 if dtype == torch.float32 else 6e-2
    torch.testing.assert_close(a.float(), want, rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("decay", [0.0, 0.05])
@pytest.mark.parametrize("B,J,d", [(8, 20, 64), (8, 16, 1), (3, 300, 64),
                                   (5, 7, 130)])
def test_sed_pool_writes_eta_for_the_backward(cuda, B, J, d, decay):
    """With residuals the launch writes η (B, J) and J_b (B, 1) as
    ref.sed_eta builds them: J_b exactly, η within 1e-6."""
    h, valid, fresh, drop, ages = _sed_inputs(B, J, d, seed=B * J + d,
                                              cuda=cuda)
    ages = ages if decay > 0 else None
    out, eta, J_b = sp._launch(h, valid, fresh, drop, ages, 0.5, 1, "mean",
                               decay, residuals=True)
    want_eta, want_J = ref.sed_eta(valid, fresh, drop, 0.5, 1, ages, decay)
    assert torch.equal(J_b, want_J)
    torch.testing.assert_close(eta, want_eta, rtol=1e-6, atol=1e-6)
    assert torch.equal(out, sp._launch(h, valid, fresh, drop, ages, 0.5, 1,
                                       "mean", decay))


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


def _quant_inputs(R, N, seed, cuda, offset=0):
    """Random rows with a zero row, ±0, values on the nearest-even ties of
    both grids, and a row whose amax is 127 (scale exactly 1); where R > 4
    and N > 3, a row with NaN of both signs, a row with ±inf and a row of
    NaN.  x is a view ``offset`` elements into its buffer."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(R, N)) * 3.0).astype(np.float32)
    x[0] = 0.0
    if R > 1:
        ties = np.asarray([-0.0, 1.0 + 2.0 ** -8, 63.5, -0.5, 2.5, 1e-30],
                          np.float32)
        x[1, :min(N, 6)] = ties[:min(N, 6)]
        x[1, -1] = 127.0
    if R > 4 and N > 3:
        x[2, 1], x[2, -2] = np.nan, -np.nan
        x[3, 0], x[3, -1] = np.inf, -np.inf
        x[4] = np.nan
    bits = rng.integers(0, 2 ** 32, (R, N), dtype=np.uint64).astype(
        np.uint32).view(np.int32)
    return (_offset(torch.from_numpy(x).to(cuda), offset),
            torch.from_numpy(bits).to(cuda))


def _offset(t, offset):
    """A contiguous copy of t ``offset`` elements into a larger buffer."""
    if not offset:
        return t
    flat = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = flat[offset:].view(t.shape)
    view.copy_(t)
    return view


def _same_bits(a, b):
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("R,N,offset", [
    (1, 4, 0), (2, 64, 0), (3, 33, 0), (8, 1280, 0), (16, 1000, 0),
    (512, 1280, 0), (1, 1280, 0), (6, 20001, 0), (8192, 1280, 0),
    (6, 1281, 1), (2, 1280, 3), (5, 33, 2)])
def test_quant_kernels_bitwise_plain(cuda, R, N, offset, dtype, stochastic):
    """Also rows wider than the int8 pack keeps in registers (20001 >
    REGISTER_N), and x and v as views ``offset`` elements into their
    buffers, so that no row starts on a 16-byte boundary."""
    from repro_torch.kernels import quant as Q

    x, bits = _quant_inputs(R, N, seed=R + N, cuda=cuda, offset=offset)
    bits = bits if stochastic else None
    ops.reset_kernel_launches()
    a = Q.quantize_rows(x, dtype, bits)
    b = Q.quantize_rows(x, dtype, bits)
    want = ref.quantize_rows_ref(x, dtype, bits)
    back_a = Q.dequantize_rows((_offset(a[0], offset),) + a[1:], dtype)
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
    if R > 4 and N > 3:       # the NaN rows carry the JAX package's bits
        nan = x.isnan()
        if dtype == "bf16":
            bits = a[0].view(torch.int16).int() & 0xFFFF
            sign = (x.view(torch.int32) < 0).int() * 0x8000
            assert torch.equal(bits[nan], (sign | 0x7FC0)[nan])
        else:
            assert torch.equal(a[1][2:5:2].view(torch.int32).cpu(),
                               torch.tensor([0x7FC00000] * 2, dtype=torch.int32))
            assert not a[0][nan].any() and not a[0][3].any()
            assert bool(torch.isinf(a[1][3]))


def _pack_int8_with(x, warps_per_row, vecs_per_lane, bits=None):
    """An int8 pack (nearest even, or stochastic with ``bits``) at a
    geometry of the caller's choosing."""
    from repro_torch.kernels import quant as Q

    R, N = x.shape
    out = torch.empty((R, N), dtype=torch.int8, device=x.device)
    scale = torch.empty((R,), dtype=torch.float32, device=x.device)
    err = Q._lib().quant_pack_int8(
        x.data_ptr(), None if bits is None else bits.data_ptr(),
        out.data_ptr(), scale.data_ptr(), R, N, warps_per_row, vecs_per_lane,
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    return out, scale


@pytest.mark.gpu
@pytest.mark.parametrize("R,N,offset", [(6, 37, 0), (6, 1280, 1), (9, 5000, 3),
                                        (300, 17, 2), (2, 1, 0)])
def test_int8_pack_every_geometry_bitwise_plain(cuda, R, N, offset):
    """Every (warps a row, float4 a thread) the kernel takes, including
    register arrays too small for the row (whose rest is read twice),
    gives the plain version's values and scales, rounding to nearest even
    and stochastically."""
    from repro_torch.kernels import quant as Q

    x, bits = _quant_inputs(R, N, seed=R * N, cuda=cuda, offset=offset)
    for b in (None, bits):
        want = ref.quantize_rows_ref(x, "int8", b)
        for W in (1, 2, 4, 8):
            for K in Q.VECS_PER_LANE:
                got = _pack_int8_with(x, W, K, b)
                torch.cuda.synchronize()
                assert all(_same_bits(g, w) for g, w in zip(got, want)), (
                    W, K, b is not None)


@pytest.mark.gpu
@pytest.mark.parametrize("R,N,x_offset", [(8192, 1280, 0), (6, 1281, 1),
                                          (9, 5000, 3), (6, 20001, 2)])
def test_int8_stochastic_pack_bits_at_every_phase_bitwise_plain(cuda, R, N,
                                                                x_offset):
    """The random bits as views 0-3 elements into their buffer, so at
    every 16-byte phase against x's (the kernel then loads them 16, 8 or
    4 bytes at a time): values and scales bitwise the plain version, two
    launches bitwise equal, through the plan and at every (W, K)."""
    from repro_torch.kernels import quant as Q

    x, bits = _quant_inputs(R, N, seed=R + N, cuda=cuda, offset=x_offset)
    for b_offset in range(4):
        b = _offset(bits, b_offset)
        want = ref.quantize_rows_ref(x, "int8", b)
        got = [Q.quantize_rows(x, "int8", b) for _ in range(2)]
        if R * N < 100_000:
            got += [_pack_int8_with(x, W, K, b) for W in (1, 2, 4, 8)
                    for K in Q.VECS_PER_LANE]
        torch.cuda.synchronize()
        for parts in got:
            assert all(_same_bits(g, w) for g, w in zip(parts, want)), b_offset


@pytest.mark.gpu
@pytest.mark.parametrize("delta", [-1, 0, 1])
@pytest.mark.parametrize("R,N", [(8, 1280), (6, 20001), (8192, 1280)])
def test_int8_stochastic_pack_boundary_bits_bitwise_plain(cuda, R, N, delta):
    """Bits on the stochastic comparison's boundary (bits >> 8 =
    floor((v - floor(v)) * 2^24) + delta, tests/_quant_cases.py): the
    kernel's values equal the plain version's, through the plan and at
    every (W, K), so its quotient is the IEEE one to the last bit."""
    from _quant_cases import boundary_bits
    from repro_torch.kernels import quant as Q

    rng = np.random.default_rng(R + N)
    x_np = (rng.normal(size=(R, N)) * 3.0).astype(np.float32)
    x_np[1, :4] = (127.0, -1.0, 0.5, 0.0)
    bits = torch.from_numpy(boundary_bits(x_np, delta, seed=N).view(
        np.int32)).to(cuda)
    x = torch.from_numpy(x_np).to(cuda)
    want = ref.quantize_rows_ref(x, "int8", bits)
    got = [Q.quantize_rows(x, "int8", bits)]
    if R * N < 200_000:
        got += [_pack_int8_with(x, W, K, bits) for W in (1, 2, 4, 8)
                for K in Q.VECS_PER_LANE]
    torch.cuda.synchronize()
    for parts in got:
        assert all(_same_bits(g, w) for g, w in zip(parts, want))


@pytest.mark.gpu
def test_int8_pack_same_on_register_and_wide_paths(cuda):
    """The same rows, zero-padded across REGISTER_N, go through the
    register path and the wide-row path (which reads its rest twice):
    values and scales agree with each other and with the plain version."""
    from repro_torch.kernels import quant as Q

    n = Q.REGISTER_N - 384
    x, _ = _quant_inputs(6, n, seed=5, cuda=cuda)
    wide = torch.zeros((6, Q.REGISTER_N + 1000), device=cuda)
    wide[:, :n] = x
    for N, fits in ((n, True), (wide.shape[1], False)):
        g = Q.plan_pack_int8(6, N)
        assert (N // 4 <= 32 * g.warps_per_row * g.vecs_per_lane) == fits
    narrow_v, narrow_s = Q.quantize_rows(x, "int8")
    wide_v, wide_s = Q.quantize_rows(wide, "int8")
    want_v, want_s = ref.quantize_rows_ref(x, "int8")
    torch.cuda.synchronize()
    assert _same_bits(narrow_s, wide_s) and _same_bits(narrow_s, want_s)
    assert torch.equal(narrow_v, wide_v[:, :n]) and torch.equal(narrow_v, want_v)
    assert not wide_v[:, n:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("R,N,v_offset,out_offset", [
    (2, 1280, 0, 0), (8192, 1280, 0, 0), (6, 37, 1, 0), (5, 1281, 3, 1),
    (300, 17, 2, 2), (7, 1, 0, 3)])
def test_int8_unpack_every_group_count_bitwise_plain(cuda, R, N, v_offset,
                                                     out_offset):
    """Every words-a-thread count the kernel takes, with v and out off
    their 16-byte boundaries, gives the plain version's bits; so does
    torch.mul(v, scale[:, None]), the library call chip_smoke.py times."""
    from repro_torch.kernels import quant as Q

    x, _ = _quant_inputs(R, N, seed=R + N, cuda=cuda)
    v, s = ref.quantize_rows_ref(x, "int8")
    v = _offset(v, v_offset)
    want = ref.dequantize_rows_ref((v, s), "int8")
    assert _same_bits(torch.mul(v, s[:, None]), want)
    for groups in Q.UNPACK_GROUPS:
        out = _offset(torch.empty((R, N), device=cuda), out_offset)
        err = Q._lib().quant_unpack_int8(
            v.data_ptr(), s.data_ptr(), out.data_ptr(), R, N, groups,
            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert err == 0 and _same_bits(out, want), groups


def _amax_for_scale(s):
    """The amax nearest 127 s whose int8 scale RN(amax * f32(1/127)) is
    exactly s (f32 arithmetic, as the kernel's)."""
    s, c = np.float32(s), np.float32(1.0) / np.float32(127.0)
    lo = hi = np.float32(np.float64(s) * 127.0)
    for _ in range(512):
        for a in (lo, hi):
            if np.isfinite(a) and np.float32(a * c) == s:
                return a
        lo, hi = np.nextafter(lo, np.float32(0)), np.nextafter(hi, np.float32(np.inf))
    raise AssertionError(f"no amax gives the scale {s!r}")


# scales of the reciprocal path: powers of two from its threshold 2^-100
# to the largest a finite row has (FLT_MAX's), one ulp below each, s = 1
# (exact ties), and others; then of the IEEE path: one ulp below 2^-100 and subnormal
_POW2 = (-100, -99, -64, -20, -1, 0, 1, 20, 64, 120, 121)
_SWEEP = sorted({float(np.float32(2.0 ** k)) for k in _POW2}
                | {float(np.nextafter(np.float32(2.0 ** k), np.float32(0)))
                   for k in _POW2}
                | {float(np.float32(v)) for v in (3.0 / 127, 0.1, 7.3, 1e-20)}
                | {float(np.finfo(np.float32).max
                         * (np.float32(1) / np.float32(127)))}
                | {float(np.nextafter(np.float32(2.0 ** -100), np.float32(0))),
                   float(np.float32(2.0 ** -140))})


@pytest.mark.gpu
@pytest.mark.parametrize("scale", _SWEEP)
def test_int8_pack_reciprocal_matches_ieee_division_every_x(cuda, scale):
    """For a row whose scale is ``scale``, every f32 x with |x| <= amax,
    both signs, in rows of 1280 (the lookup's N) led by ±amax: the
    kernel's values equal the plain version's (IEEE division, round half
    to even) and its scales; the plain version on the card agrees with
    the CPU's on a sample.  The kernel divides by the reciprocal with one
    FMA correction for scales in [2^-100, FLT_MAX], by __fdiv_rn below.  A
    subnormal scale is flushed to 0, as the JAX package's arithmetic does
    (the row is then divided by 1)."""
    from repro_torch.kernels import quant as Q

    amax = _amax_for_scale(scale)
    kept = scale if scale >= np.finfo(np.float32).tiny else 0.0
    top = int(np.asarray(amax, np.float32).view(np.int32)) + 1
    per_row, rows = 1279, 1 << 15
    chunk = per_row * rows
    sample = torch.Generator().manual_seed(0)
    for start in range(0, top, chunk):
        pats = torch.arange(start, min(start + chunk, top), dtype=torch.int32,
                            device=cuda)
        xs = torch.zeros(chunk, device=cuda)
        xs[:pats.numel()] = pats.view(torch.float32)
        for sign in (1.0, -1.0):
            x = torch.empty((rows, per_row + 1), device=cuda)
            x[:, 0] = sign * float(amax)
            x[:, 1:] = sign * xs.view(rows, per_row)
            v, s = Q.quantize_rows(x, "int8")
            want_v, want_s = ref.quantize_rows_ref(x, "int8")
            assert _same_bits(s, want_s) and bool((s == kept).all())
            assert torch.equal(v, want_v), (scale, start, sign)
            pick = torch.randint(0, rows, (64,), generator=sample)
            cpu_v, _ = ref.quantize_rows_ref(x[pick.to(cuda)].cpu(), "int8")
            assert torch.equal(cpu_v, want_v[pick.to(cuda)].cpu())


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
@pytest.mark.parametrize("bits_kind", [None, "high24_zero", "random"])
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("n", [8, 130, 1280])
def test_quant_kernels_subnormal_rows_bitwise_plain(cuda, n, dtype, bits_kind):
    """Subnormal rows (tests/_quant_cases.py: scales under, at and just
    above FLT_MIN, subnormal x and quotients, bit words whose high 24 bits
    are zero): packs and unpacks bitwise their plain versions, which flush
    the int8 arithmetic's subnormals as the JAX package's does and keep
    the bf16 paths' (tests/test_torch_quant.py holds those to JAX)."""
    from _quant_cases import subnormal_rows
    from repro_torch.kernels import quant as Q

    x_np, low = subnormal_rows(n, seed=n)
    rng = np.random.default_rng(n)
    bits_np = {None: None, "high24_zero": low,
               "random": rng.integers(0, 2 ** 32, x_np.shape,
                                      dtype=np.uint64).astype(np.uint32)
               }[bits_kind]
    x = torch.from_numpy(x_np).to(cuda)
    bits = (None if bits_np is None else
            torch.from_numpy(bits_np.view(np.int32)).to(cuda))
    got = Q.quantize_rows(x, dtype, bits)
    want = ref.quantize_rows_ref(x, dtype, bits)
    back = Q.dequantize_rows(got, dtype)
    torch.cuda.synchronize()
    assert all(_same_bits(g, w) for g, w in zip(got, want))
    assert _same_bits(back, ref.dequantize_rows_ref(want, dtype))
    sub = (x != 0) & (x.abs() < torch.finfo(torch.float32).tiny)
    if dtype == "int8":
        assert not got[0][sub].any() and not got[1][:2].any()
    else:
        assert bool((back[sub] != 0).any())


@pytest.mark.gpu
def test_int8_unpack_subnormal_scale_is_signed_zero(cuda):
    """(5, -3) at scales ±1e-40 unpack to (0, -0) and (-0, 0), as the plain
    version (and the JAX package) give them; torch.mul keeps the
    subnormal products."""
    from _quant_cases import subnormal_unpack
    from repro_torch.kernels import quant as Q

    v, s = (torch.from_numpy(a).to(cuda) for a in subnormal_unpack())
    got = Q.dequantize_rows((v, s), "int8")
    want = ref.dequantize_rows_ref((v, s), "int8")
    assert _same_bits(got, want)
    assert got.view(torch.int32).cpu().tolist() == [[0, -2 ** 31],
                                                    [-2 ** 31, 0]]


def _store_ops(n, J, d, steps, seed):
    """A random sequence of (rows, segment slots, values, step): batches
    of 1-4 distinct rows, one segment slot each written."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(steps):
        b = int(rng.integers(1, 5))
        rows = rng.choice(n, b, replace=False)
        seg = rng.integers(0, J, (b, 1))
        vals = rng.normal(size=(b, 1, d)).astype(np.float32)
        out.append((rows, seg, vals, t))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["lru", "stale-first"])
def test_tiered_migration_on_card_matches_device_store(cuda, policy):
    """A TieredStore on the card (pinned host tier, side-stream copies)
    holding 4 of 40 rows, driven by the same begins, commits and in-place
    writes as a DeviceStore: the snapshots are bitwise equal, with
    faults and evictions on the way."""
    from repro_torch.core import embedding_table as tbl
    from repro_torch.store import DeviceStore, TieredStore

    n, J, d = 40, 3, 16
    dense = DeviceStore(n, J, d, device=cuda)
    tiered = TieredStore(n, J, d, device_rows=4, device=cuda,
                         evict_policy=policy)
    assert tiered._host[0].emb.is_pinned()
    t_dense, t_tier = dense.init_device_table(), tiered.init_device_table()
    for rows, seg, vals, t in _store_ops(n, J, d, 200, seed=3):
        for store, table in ((dense, t_dense), (tiered, t_tier)):
            table, slots = store.prepare(table, rows, step=t)
            tbl.update_sampled(table, torch.from_numpy(
                slots.astype(np.int64)).to(cuda),
                torch.from_numpy(seg).to(cuda),
                torch.from_numpy(vals).to(cuda), t)
        if t % 50 == 49:
            tiered.refresh_ages(t_tier)
    want, got = dense.snapshot(t_dense), tiered.snapshot(t_tier)
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    assert tiered.counters.evictions > 100 and tiered.counters.misses > 100
    tiered.close()


@pytest.mark.gpu
def test_tiered_eviction_copy_survives_an_in_place_write(cuda):
    """A row evicted by a commit goes home with its content at the commit,
    although the step right after it writes the same slot in place (the
    new row's) before the device -> host copy lands."""
    from repro_torch.core import embedding_table as tbl
    from repro_torch.store import TieredStore

    n, J, d = 6, 1, 1 << 16          # 256 KiB a row: a copy that takes time
    store = TieredStore(n, J, d, device_rows=1, device=cuda)
    table = store.init_device_table()
    zero = torch.zeros((1, 1), dtype=torch.long, device=cuda)
    for t in range(n):
        table, slots = store.prepare(table, np.asarray([t]))
        slot = torch.from_numpy(slots.astype(np.int64)).to(cuda)
        # the write lands in the slot the previous row was just evicted from
        tbl.update_sampled(table, slot, zero,
                           torch.full((1, 1, d), float(t + 1), device=cuda),
                           t)
    store.flush_writebacks()
    for t in range(n - 1):
        assert bool((store._host[0].emb[t] == float(t + 1)).all()), t
    snap = store.snapshot(table)
    assert torch.equal(snap.emb[:, 0, 0], torch.arange(1.0, n + 1))
    store.close()


@pytest.mark.gpu
def test_capped_training_on_card_is_bitwise_uncapped(cuda):
    """run_experiment on the card with about 10% of the rows device-resident
    gives the uncapped run's metrics bit for bit."""
    from repro_torch.graphs.experiment import run_experiment

    kw = dict(n_graphs=48, max_seg_nodes=32, hidden=16, batch_size=4,
              epochs=2, finetune_epochs=1, device="cuda")
    a = run_experiment(**kw)
    b = run_experiment(table_device_rows=4, **kw)
    assert (a.train_metric, a.test_metric) == (b.train_metric, b.test_metric)
    assert b.store_stats["evictions"] > 0


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


# ---------------------------------------------------------------------------
# sliding-window attention
# ---------------------------------------------------------------------------

# (B, S, H, KV, D, W; None = full causal): chip_smoke.py's phase-3 shapes,
# the last three the head shapes of qwen2-vl-7b, arctic-480b and
# whisper-large-v3's decoder
SWA_CASES = [(2, 256, 4, 2, 64, 128), (1, 2048, 16, 8, 128, None),
             (1, 4096, 16, 8, 128, 1024), (2, 1000, 16, 8, 128, 300),
             (1, 1, 16, 8, 128, None), (1, 777, 6, 1, 128, 1),
             (2, 513, 8, 8, 64, 33), (1, 2048, 28, 4, 128, None),
             (1, 2048, 56, 8, 128, None), (2, 448, 20, 20, 64, None)]


def _swa_inputs(B, S, H, KV, D, seed, cuda):
    g = torch.Generator(cuda).manual_seed(seed)
    return (torch.randn(B, S, H, D, device=cuda, generator=g),
            torch.randn(B, S, KV, D, device=cuda, generator=g),
            torch.randn(B, S, KV, D, device=cuda, generator=g))


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,D,W", SWA_CASES)
def test_swa_kernel_matches_plain_and_is_deterministic(cuda, B, S, H, KV, D,
                                                       W):
    from repro_torch.kernels import swa_attention as swa

    q, k, v = _swa_inputs(B, S, H, KV, D, seed=S, cuda=cuda)
    W = S if W is None else W
    ops.reset_kernel_launches()
    a = swa.swa_attention(q, k, v, window=W)
    b = swa.swa_attention(q, k, v, window=W)
    want = ref.swa_attention_ref(q, k, v, W)
    torch.cuda.synchronize()
    assert ops.kernel_launches()["swa_attention"] == 2
    assert torch.equal(a, b)
    torch.testing.assert_close(a, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,D,W", [(2, 300, 3, 1, 128, 100),
                                          (1, 200, 6, 2, 64, 200)])
def test_swa_kernel_odd_group_ratio(cuda, B, S, H, KV, D, W):
    """An odd GQA ratio (3): one query head a block, 128 positions, at
    both head dims."""
    from repro_torch.kernels import swa_attention as swa

    q, k, v = _swa_inputs(B, S, H, KV, D, seed=S + H, cuda=cuda)
    a = swa.swa_attention(q, k, v, window=W)
    torch.cuda.synchronize()
    assert torch.equal(a, swa.swa_attention(q, k, v, window=W))
    torch.testing.assert_close(a, ref.swa_attention_ref(q, k, v, W),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_swa_kernel_reads_strided_heads(cuda):
    """q, k, v as column slices of one fused projection (strided heads),
    and a window larger than S."""
    from repro_torch.kernels import swa_attention as swa

    B, S, H, KV, D = 2, 300, 4, 2, 64
    g = torch.Generator(cuda).manual_seed(0)
    qkv = torch.randn(B, S, (H + 2 * KV) * D, device=cuda, generator=g)
    q = qkv[..., :H * D].unflatten(-1, (H, D))
    k = qkv[..., H * D:(H + KV) * D].unflatten(-1, (KV, D))
    v = qkv[..., (H + KV) * D:].unflatten(-1, (KV, D))
    assert not q.is_contiguous()
    got = swa.swa_attention(q, k, v, window=10_000)
    torch.testing.assert_close(got, ref.swa_attention_ref(q, k, v, 10_000),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_swa_kernel_refuses_what_it_cannot_do(cuda):
    from repro_torch.kernels import swa_attention as swa

    q, k, v = _swa_inputs(1, 64, 4, 2, 96, seed=0, cuda=cuda)
    with pytest.raises(ValueError, match="head dim 96"):
        swa.swa_attention(q, k, v, window=64)
    q, k, v = _swa_inputs(1, 64, 4, 2, 64, seed=0, cuda=cuda)
    with pytest.raises(TypeError, match="float32"):
        swa.swa_attention(q.half(), k.half(), v.half(), window=64)
    with pytest.raises(ValueError, match="runs on cuda"):
        swa._launch(q.cpu(), k.cpu(), v.cpu(), 64)
    with pytest.raises(ValueError, match="is on cpu"):
        swa.swa_attention(q, k.cpu(), v, window=64)
    with pytest.raises(ValueError, match="window"):
        swa.swa_attention(q, k, v, window=0)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,num_kv", [("internlm2-1.8b", 2),
                                         ("olmo-1b", None)])
def test_dense_model_kernel_path_matches_plain(cuda, arch, num_kv):
    """The reduced dense transformer (head dim 64) on the card: prefill's
    last logits and caches, and a windowed forward, through the kernel
    (one launch a layer) against the plain path, at 5e-4 (the reference's
    forward-vs-decode tolerance)."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model

    cfg = reduced(get_config(arch))
    if num_kv:
        cfg = dataclasses.replace(cfg, num_kv_heads=num_kv)
    kern = build_model(cfg, use_kernels=True, device=cuda)
    plain = build_model(cfg, use_kernels=False, device=cuda)
    params = kern.init(torch.Generator(cuda).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 200), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(1))
    ops.reset_kernel_launches()
    lk, ck = kern.prefill(params, {"tokens": toks})
    assert ops.kernel_launches()["swa_attention"] == cfg.num_layers
    lp, cp = plain.prefill(params, {"tokens": toks})
    torch.testing.assert_close(lk, lp, rtol=5e-4, atol=5e-4)
    for name in ("k", "v"):
        torch.testing.assert_close(ck[0][name], cp[0][name], rtol=5e-4,
                                   atol=5e-4)
    torch.testing.assert_close(kern.forward(params, {"tokens": toks}, window=64),
                               plain.forward(params, {"tokens": toks},
                                             window=64),
                               rtol=5e-4, atol=5e-4)


def _family_inputs(cfg, B, S, cuda, seed):
    g = torch.Generator(cuda).manual_seed(seed)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), device=cuda,
                                   generator=g)}
    if cfg.family == "vlm":
        out["patches"] = torch.randn(B, cfg.vision_prefix_len, cfg.d_model,
                                     device=cuda, generator=g)
    if cfg.is_encoder_decoder:
        out["frames"] = torch.randn(B, cfg.encoder_seq_len, cfg.d_model,
                                    device=cuda, generator=g)
    return out


def _leaves(tree):
    from repro_torch.models.common import flatten_tree

    return dict(flatten_tree(tree))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["arctic-480b", "deepseek-v3-671b",
                                  "qwen2-vl-7b", "whisper-large-v3"])
def test_family_model_kernel_path_matches_plain_and_decode(cuda, arch):
    """The reduced attention families on the card: prefill (last logits,
    every cache) and encode_segment through the kernel (one launch a
    causal self-attention layer; none for MLA or whisper's encoder)
    against the plain path, and the decode loop over the prompt against
    prefill, at 5e-4."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model, encdec

    cfg = reduced(get_config(arch))
    kern = build_model(cfg, use_kernels=True, device=cuda)
    plain = build_model(cfg, use_kernels=False, device=cuda)
    params = kern.init(torch.Generator(cuda).manual_seed(0))
    per_pass = 0 if cfg.use_mla else cfg.num_layers
    inp = _family_inputs(cfg, 2, 100, cuda, 1)
    ops.reset_kernel_launches()
    lk, ck = kern.prefill(params, inp)
    assert ops.kernel_launches()["swa_attention"] == per_pass
    lp, cp = plain.prefill(params, inp)
    assert ops.kernel_launches()["swa_attention"] == per_pass
    torch.testing.assert_close(lk, lp, rtol=5e-4, atol=5e-4)
    got, want = _leaves(ck), _leaves(cp)
    assert set(got) == set(want)
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=5e-4,
                                   atol=5e-4)
    torch.testing.assert_close(kern.encode_segment(params, inp)[0],
                               plain.encode_segment(params, inp)[0],
                               rtol=5e-4, atol=5e-4)

    # decode over a prompt of 12 (text only) = its prefill
    B, S = 2, 12
    inp = _family_inputs(cfg, B, S, cuda, 2)
    inp.pop("patches", None)
    lp, cp = kern.prefill(params, inp)
    caches = kern.init_cache(B, S)
    if cfg.is_encoder_decoder:
        caches = {"self": caches, "cross": encdec.cross_kv(
            params, cfg, encdec.encode(params, cfg, inp["frames"]))}
    for t in range(S):
        ld, caches = kern.decode_step(params, inp["tokens"][:, t:t + 1],
                                      caches, torch.full((B,), t,
                                                         device=cuda))
    torch.testing.assert_close(ld, lp, rtol=5e-4, atol=5e-4)
    got, want = _leaves(caches), _leaves(cp)
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=5e-4,
                                   atol=5e-4)
