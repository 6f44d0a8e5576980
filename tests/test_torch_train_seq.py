"""The port's sequence track (``launch/train.py --track seq``) on the CPU:

  * ``data/tokens.py`` is bitwise the reference's three functions;
  * 3 GST steps over the reduced internlm2-1.8b's ``encode_segment``
    (batches 0, 1 and 0 again, so the third reads rows the first wrote)
    against JAX's ``make_train_step``, for gst, gst_e and gst_efd, the
    port's step built by ``seq_setup`` (kernels on: their plain versions
    here) with JAX's weights carried in and JAX's draws replayed: loss,
    metric and gradient norm rtol 1e-4, the gradients 1e-4 (from the Adam
    first moment), the table 1e-5 with ages and flags equal
    (tests/test_fused_path.py:48,73, tests/test_torch_train.py);
  * ``--track seq --device cpu --reduced`` prints the uncapped run's losses
    bitwise under ``--table-device-rows``; ``--ckpt-dir`` writes a
    checkpoint that ``load_checkpoint`` reads back; a GST step runs
    backward through every reduced config;
  * the attention route: a call autograd records takes the plain version,
    a no-grad call the kernel's route, and the kernel's own check still
    refuses inputs that need a gradient.
"""
import argparse

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import (assert_tables_match, copy_jax_state,  # noqa: E402
                           jax_draws, jax_named, named_moments, named_params,
                           np_tree)
from repro import configs as jconfigs  # noqa: E402
from repro.core import gst as JG  # noqa: E402
from repro.core.embedding_table import init_table as jinit_table  # noqa: E402
from repro.data import tokens as jtokens  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro_torch.checkpoint import latest_checkpoint, load_checkpoint  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.core import gst as G  # noqa: E402
from repro_torch.data import tokens  # noqa: E402
from repro_torch.kernels import ops, swa_attention as swa  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.models.common import flatten_tree, load_jax_params  # noqa: E402

B1 = 0.9
NOISE_FLOOR = 1e-6
ARCH = "internlm2-1.8b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes on
    the same cores, and small ops then spend their time in thread
    hand-offs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(**kw):
    args = T.build_parser().parse_args(
        ["--track", "seq", "--device", "cpu", "--reduced", "--arch", ARCH,
         "--n-docs", "8", "--batch-size", "4", "--seg-len", "16",
         "--steps", "3"])
    for k, v in kw.items():
        setattr(args, k, v)
    return args


# ---------------------------------------------------------------------------
# the token pipelines: a copy, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
def test_tokens_are_bitwise_the_reference(seed):
    kw = dict(n_docs=12, n_segments=3, seg_len=10, vocab=97, n_topics=4,
              seed=seed)
    got, want = tokens.make_property_docs(**kw), \
        jtokens.make_property_docs(**kw)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    for shuffle in (True, False):
        a = list(tokens.doc_batch_iterator(
            got, 5, rng=np.random.default_rng(seed), shuffle=shuffle))
        b = list(jtokens.doc_batch_iterator(
            want, 5, rng=np.random.default_rng(seed), shuffle=shuffle))
        assert len(a) == len(b) == 2
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x[0]["tokens"], y[0]["tokens"])
            for i in (1, 2, 3):
                np.testing.assert_array_equal(x[i], y[i])
    np.testing.assert_array_equal(tokens.make_lm_stream(9, 13, 50, seed),
                                  jtokens.make_lm_stream(9, 13, 50, seed))


# ---------------------------------------------------------------------------
# GST steps against JAX
# ---------------------------------------------------------------------------


def _jax_side(args, variant, table_rows):
    """JAX's jitted train step over the reduced model's encode_segment, its
    state (weights from key 0, the head from fold_in(key, 1), AdamW at
    0.01 weight decay: src/repro/launch/train.py:62-91) over ``table_rows``
    (emb, initialized)."""
    jcfg = jconfigs.reduced(jconfigs.get_config(ARCH))
    jm = jbuild_model(jcfg)
    key = jax.random.key(0)
    params = jm.init(key)
    head = JG.head_init(jax.random.fold_in(key, 1), jcfg.d_model,
                        jcfg.gst_num_classes, "mlp")
    opt = jmake_optimizer("adamw", lr=args.lr, weight_decay=0.01)
    table = jinit_table(args.n_docs, jcfg.gst_num_segments, jcfg.d_model)
    table = table._replace(emb=jnp.asarray(table_rows[0]),
                           initialized=jnp.asarray(table_rows[1]))
    state = JG.TrainState(params, head, opt.init((params, head)), table,
                          jnp.zeros((), jnp.int32))
    step = jax.jit(JG.make_train_step(
        lambda p, s: jm.encode_segment(p, s), opt, JG.VARIANTS[variant],
        keep_prob=args.keep_prob))
    return state, step


@pytest.mark.parametrize("variant", ["gst", "gst_e", "gst_efd"])
def test_three_seq_steps_match_jax(variant):
    args = _args(variant=variant)
    model, docs, st, step, store = T.seq_setup(args)
    J, d = model.cfg.gst_num_segments, model.cfg.d_model
    rows = (np.random.default_rng(5).normal(size=(args.n_docs, J, d))
            .astype(np.float32), np.ones((args.n_docs, J), bool))
    js, jstep = _jax_side(args, variant, rows)
    load_jax_params(st.backbone, np_tree(js.backbone))
    load_jax_params(st.head, np_tree(js.head))
    with torch.no_grad():
        st.table.emb.copy_(torch.from_numpy(rows[0]))
        st.table.initialized.copy_(torch.from_numpy(rows[1]))
    tups = list(tokens.doc_batch_iterator(docs, args.batch_size,
                                          rng=np.random.default_rng(0),
                                          shuffle=False))
    rng = jax.random.key(7)
    for i, tup in enumerate([tups[0], tups[1], tups[0]]):
        mu_prev = jax_named(js.opt_state["mu"])
        js, jm_ = jstep(js, JG.GSTBatch(
            {"tokens": jnp.asarray(tup[0]["tokens"])}, jnp.asarray(tup[1]),
            jnp.asarray(tup[2]), jnp.asarray(tup[3])), rng)
        st, m = step(st, T.seq_batch(model, tup, tup[2], args.seed, i),
                     draws=jax_draws(rng, i, tup[1], 1))
        for k in ("loss", "metric", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm_[k]), rtol=1e-4,
                                       atol=1e-5, err_msg=f"step {i} {k}")
        mu_want = jax_named(js.opt_state["mu"])
        p_want = jax_named((js.backbone, js.head))
        p_got = named_params(st)
        for name, mu in named_moments(st).items():
            g = (mu.numpy() - B1 * mu_prev[name]) / (1 - B1)
            g_want = (mu_want[name] - B1 * mu_prev[name]) / (1 - B1)
            np.testing.assert_allclose(g, g_want, rtol=1e-4, atol=1e-4,
                                       err_msg=f"step {i} gradient of {name}")
            held = (np.abs(g) >= NOISE_FLOOR) | (np.abs(g_want) >= NOISE_FLOOR)
            np.testing.assert_allclose(
                p_got[name].detach().numpy()[held], p_want[name][held],
                rtol=1e-4, atol=1e-4, err_msg=f"step {i} {name}")
        assert_tables_match(js.table, st.table)
        st = copy_jax_state(js, st)
    store.close()


# ---------------------------------------------------------------------------
# the CLI: capped = uncapped, checkpoints, every family trains
# ---------------------------------------------------------------------------


def test_cli_capped_table_prints_the_uncapped_losses(capsys):
    base = ["--track", "seq", "--device", "cpu", "--reduced", "--n-docs",
            "16", "--batch-size", "4", "--seg-len", "16", "--steps", "8",
            "--log-every", "1", "--variant", "gst_efd"]
    a = T.main(base)
    b = T.main(base + ["--table-device-rows", "4",
                       "--evict-policy", "stale-first"])
    assert a.losses == b.losses and a.metrics == b.metrics
    assert np.isfinite(a.losses).all() and len(a.losses) == 8
    st = b.store_stats
    assert st["backend"] == "TieredStore" and st["device_rows"] == 4
    assert st["evictions"] > 0
    out = capsys.readouterr().out
    assert out.count("step 8: loss=") == 2 and "store [TieredStore]" in out


def test_cli_checkpoint_reads_back(tmp_path):
    r = T.main(["--track", "seq", "--device", "cpu", "--reduced",
                "--n-docs", "8", "--batch-size", "4", "--seg-len", "16",
                "--steps", "2", "--ckpt-dir", str(tmp_path)])
    path = latest_checkpoint(str(tmp_path))
    assert path == r.ckpt and path.endswith("step_00000002.ckpt")
    like = {"backbone": r.state.backbone.tree,
            "head": dict(r.state.head.named_parameters())}
    back = load_checkpoint(path, like)
    got, want = dict(flatten_tree(back)), dict(flatten_tree(like))
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k].detach()) for k in want)


def test_cli_lm_track_loss_falls():
    r = T.main(["--track", "lm", "--device", "cpu", "--reduced", "--steps",
                "12", "--batch-size", "4", "--seg-len", "16", "--n-docs",
                "32", "--lr", "3e-3"])
    assert np.isfinite(r.losses).all() and len(r.losses) == 12
    assert np.mean(r.losses[-3:]) < r.losses[0]


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="is_available"):
        T.main(["--track", "seq", "--reduced", "--steps", "1"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_a_gst_step_trains_every_family(arch):
    """One gst_efd step of every reduced config (the encoder-decoder over
    stub frames): finite loss, every backbone parameter reached by a
    gradient that is finite, the table written."""
    args = _args(arch=arch, variant="gst_efd", n_docs=4, batch_size=2,
                 seg_len=8)
    model, docs, st, step, store = T.seq_setup(args)
    tup = next(tokens.doc_batch_iterator(docs, 2,
                                         rng=np.random.default_rng(0)))
    before = [p.detach().clone() for p in st.backbone.parameters()]
    st, m = step(st, T.seq_batch(model, tup, tup[2], 0, 0),
                 T.epoch_generator(0, 0))
    store.close()
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"])) and float(m["grad_norm"]) > 0
    assert any(not torch.equal(a, b) for a, b in zip(
        before, st.backbone.parameters()))
    assert all(torch.isfinite(p).all() for p in st.backbone.parameters())
    assert st.table.initialized.any()


# ---------------------------------------------------------------------------
# the attention route under autograd
# ---------------------------------------------------------------------------


def test_attention_launches_or_raises_and_plain_trains(monkeypatch):
    """The op takes the kernel's route whenever ``use_kernels`` is set; a
    call that autograd records raises there (on the CPU too), and the
    plain version (``use_kernels`` False) trains."""
    calls = []
    real = ops._swa.swa_attention

    def spy(q, k, v, *, window):
        calls.append(window)
        return real(q, k, v, window=window)

    monkeypatch.setattr(ops._swa, "swa_attention", spy)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 8, 4, 64, generator=g) for _ in range(3))
    want = ops.ref.swa_attention_ref(q, k, v, 8)
    # no gradient anywhere: the kernel's route
    assert torch.equal(ops.sliding_window_attention(q, k, v, window=8), want)
    assert calls == [8]
    # q needs a gradient and autograd records: the kernel's route raises
    qg = q.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="requires grad"):
        ops.sliding_window_attention(qg, k, v, window=8)
    assert calls == [8, 8]
    # the same inputs under no_grad: the kernel's route answers
    with torch.no_grad():
        assert torch.equal(ops.sliding_window_attention(qg, k, v, window=8),
                           want)
    assert calls == [8, 8, 8]
    # use_kernels False never reaches the kernel, and trains
    out = ops.sliding_window_attention(qg, k, v, window=8, use_kernels=False)
    assert calls == [8, 8, 8] and out.requires_grad
    assert torch.equal(out.detach(), want)
    out.sum().backward()
    assert qg.grad is not None and torch.isfinite(qg.grad).all()


def test_the_kernel_still_refuses_grad_inputs():
    q = torch.zeros(1, 4, 2, 64, requires_grad=True)
    k = v = torch.zeros(1, 4, 2, 64)
    with pytest.raises(RuntimeError, match="requires grad"):
        swa._check(q, k, v)
    with pytest.raises(RuntimeError, match="requires grad"):
        swa.swa_attention(q, k, v, window=4)
    with torch.no_grad():
        swa._check(q, k, v)
        swa.swa_attention(q, k, v, window=4)


def test_a_model_with_kernels_refuses_a_training_pass():
    """A ``Model`` built with kernels raises on a pass that autograd records
    over trainable parameters: nothing falls back to the plain version."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.models.common import ParamTree

    cfg = reduced(get_config("internlm2-1.8b"))
    model = build_model(cfg, use_kernels=True, device="cpu")
    tree = ParamTree(model.init(torch.Generator().manual_seed(0)))
    inp = {"tokens": torch.zeros(1, 8, dtype=torch.long)}
    with pytest.raises(RuntimeError, match="requires grad"):
        model.encode_segment(tree.tree, inp)
    with torch.no_grad():
        h, _ = model.encode_segment(tree.tree, inp)
    plain = build_model(cfg, use_kernels=False, device="cpu")
    hp, _ = plain.encode_segment(tree.tree, inp)
    assert hp.requires_grad and torch.equal(hp.detach(), h)


def test_gst_reencode_takes_the_kernel_route_and_training_does_not(
        monkeypatch):
    """In a gst step the stale re-encode of all B·J segments (no grad) is
    one attention call a layer through the kernel's route, and the sampled
    encode under autograd takes the plain version; gst_efd never reaches
    the kernel."""
    calls = []
    real = ops._swa.swa_attention

    def spy(q, k, v, *, window):
        calls.append(q.shape[0])
        return real(q, k, v, window=window)

    monkeypatch.setattr(ops._swa, "swa_attention", spy)
    for variant, want in (("gst", None), ("gst_efd", [])):
        args = _args(variant=variant)
        model, docs, st, step, store = T.seq_setup(args)
        tup = next(tokens.doc_batch_iterator(docs, args.batch_size,
                                             rng=np.random.default_rng(0)))
        calls.clear()
        step(st, T.seq_batch(model, tup, tup[2], 0, 0),
             T.epoch_generator(0, 0))
        store.close()
        B, J = args.batch_size, model.cfg.gst_num_segments
        if want is None:
            want = [B * J] * model.cfg.num_layers
        assert calls == want, variant


def test_run_options_default_to_the_reference():
    args = T.build_parser().parse_args(["--track", "seq"])
    assert (args.arch, args.steps, args.batch_size, args.seg_len,
            args.n_docs, args.log_every, args.lr, args.device) == \
        ("internlm2-1.8b", 100, 8, 64, 64, 10, 1e-3, "cuda")
    assert isinstance(args, argparse.Namespace) and args.use_kernels
