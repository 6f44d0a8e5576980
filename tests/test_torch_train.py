"""The port's GST train steps against the JAX package's, step by step.

JAX's parameters are carried into the port, both Adam states start at
zeros, both tables hold the same rows written before (so stale embeddings
enter from the first step), and JAX's own draws (``split(fold_in(rng,
step))``, src/repro/core/gst.py:248-284) are injected into the port's step.
Three steps (batches 0, 1, then 0 again, so the third step reads rows the
first one wrote) are compared at the reference's tolerances
(tests/test_fused_path.py:48,73,185): loss, metric and gradient norm rtol
1e-4, atol 1e-5; the step's gradients 1e-4 (read from the Adam first
moment: mu_t = b1·mu_(t-1) + (1 - b1)·g_t); the parameters after the step
atol 1e-4; the table 1e-5 with ages and ``initialized`` bitwise.

Each step starts from the same state in both packages: after a step is
compared, the port's state is set to JAX's.  Adam's eps (1e-8) turns float
noise in an exactly-zero gradient into a step of up to lr·|g|/(|g| + eps):
on the TpuGraphs track some post-layer bias channels get exactly 0 in the
port and ±1e-10 in JAX, which moves them by up to 5e-4 in one step.
Carried over three steps, that noise of the reference, not the port, would
set every later difference.  For the same reason a parameter element whose
gradient is below 1e-6 in both packages is held by its gradient (compared
above at 1e-4) instead of its value after the step.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import (Pair, assert_tables_match, batches,  # noqa: E402
                           copy_jax_state, jax_batch, jax_draws, jax_named,
                           named_moments, named_params, port_batch)
from repro.core import gst as JG  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

B1 = 0.9            # Adam's b1 (make_optimizer's default)
NOISE_FLOOR = 1e-6  # a gradient below this is float noise around 0


def _three_steps(dataset, backbone, variant, *, use_pallas=False,
                 sed_decay=0.0, num_sampled=1):
    ds, tups = batches(dataset)
    pair = Pair(dataset, backbone, n_table=ds.n, j_max=ds.j_max,
                table_valid=ds.seg_valid)
    jstep, step = pair.steps(variant, use_pallas=use_pallas,
                             num_sampled=num_sampled, sed_decay=sed_decay)
    rng = jax.random.key(7)
    js, st = pair.jstate, pair.state
    for i, tup in enumerate([tups[0], tups[1], tups[0]]):
        mu_prev = jax_named(js.opt_state["mu"])
        js, jm = jstep(js, jax_batch(tup), rng)
        st, m = step(st, port_batch(tup),
                     draws=jax_draws(rng, i, tup[1], num_sampled))
        for k in ("loss", "metric", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
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
        assert st.step == int(js.step) == i + 1
        st = copy_jax_state(js, st)
    return st


@pytest.mark.parametrize("variant", list(JG.VARIANTS))
def test_variants_sage_malnet_match_jax(variant):
    _three_steps("malnet", "sage", variant)


@pytest.mark.parametrize("backbone", ["gcn", "gps"])
def test_backbones_gst_efd_match_jax(backbone):
    _three_steps("malnet", backbone, "gst_efd")


@pytest.mark.parametrize("variant", ["gst_ef", "gst_efd"])
def test_tpugraphs_segment_sum_matches_jax(variant):
    _three_steps("tpugraphs", "sage", variant)


def test_aged_kernel_path_matches_jax_pallas():
    """λ = 0.1 on the kernel path: the port's sed_pool_aged (its plain
    version, here) against JAX's aged Pallas kernel in interpret mode."""
    ops.reset_kernel_launches()
    _three_steps("malnet", "sage", "gst_efd", use_pallas=True, sed_decay=0.1)
    assert sum(ops.kernel_launches().values()) == 0     # CPU: plain versions


# ---------------------------------------------------------------------------
# eval, refresh and finetune (Algorithm 2 lines 11-18), both heads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("dataset", ["malnet", "tpugraphs"])
def test_eval_refresh_finetune_match_jax(dataset, use_kernels):
    from repro.graphs.gnn import make_encode_fn as jmake_encode_fn
    from repro.optim import make_optimizer as jmake_optimizer
    from repro_torch.core import gst as G
    from repro_torch.graphs.gnn import make_encode_fn
    from repro_torch.optim import make_optimizer

    ds, tups = batches(dataset)
    pair = Pair(dataset, "sage", n_table=ds.n, j_max=ds.j_max,
                table_valid=ds.seg_valid)
    kw = dict(head_mode=pair.head_mode, loss_kind=pair.loss_kind,
              agg=pair.agg)
    jenc, enc = jmake_encode_fn(pair.jcfg), make_encode_fn(pair.cfg)
    js, st = pair.jstate, pair.state

    jm = jax.jit(JG.make_eval_step(jenc, **kw))(js, jax_batch(tups[1]))
    m = G.make_eval_step(enc, use_kernels=use_kernels, **kw)(
        st, port_batch(tups[1]))
    for k in ("loss", "metric"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=f"eval {k}")

    js = jax.jit(JG.make_refresh_step(jenc))(js, jax_batch(tups[0]))
    st = G.make_refresh_step(enc)(st, port_batch(tups[0]))
    assert_tables_match(js.table, st.table)

    jft_opt = jmake_optimizer("adam", lr=5e-3)
    ft_opt = make_optimizer("adam", lr=5e-3)
    js = js._replace(opt_state=jft_opt.init(js.head))
    st = st._replace(opt_state=ft_opt.init(list(st.head.parameters())))
    jft = jax.jit(JG.make_finetune_step(jft_opt, **kw))
    ft = G.make_finetune_step(ft_opt, use_kernels=use_kernels, **kw)
    backbone0 = {n: p.detach().clone()
                 for n, p in st.backbone.named_parameters()}
    head0 = {n: p.detach().clone() for n, p in st.head.named_parameters()}
    for i, tup in enumerate([tups[0], tups[0]]):
        js, jm = jft(js, jax_batch(tup))
        st, m = ft(st, port_batch(tup))
        for k in ("loss", "metric"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                       atol=1e-5, err_msg=f"finetune {i} {k}")
    want = jax_named(js.head)
    for name, p in st.head.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    # the head moved; the backbone is bitwise as it was
    assert any(not torch.equal(head0[n], p)
               for n, p in st.head.named_parameters())
    for n, p in st.backbone.named_parameters():
        assert torch.equal(backbone0[n], p), n
    assert st.step == int(js.step) == 2


@pytest.mark.parametrize("dataset,decay", [("malnet", 0.0),
                                           ("tpugraphs", 0.0),
                                           ("malnet", 0.1)])
def test_step_parity_kernel_path_matches_plain_path(dataset, decay):
    """The comparison the card runs (repro_torch.core.step_parity), here
    with the kernels' plain versions: the fused sed_pool composition (η
    built from the masks, uninitialized stale slots folded into the drop
    operand, the ages) against the plain η of the step, over batches 0, 1,
    0, with stale segments kept; no launch on the CPU."""
    from repro_torch.core.step_parity import kernel_step_parity

    ds, tups = batches(dataset)
    pair = Pair(dataset, "sage", n_table=ds.n, j_max=ds.j_max)
    runs = []
    for use_kernels in (True, False):
        _, step = pair.steps("gst_efd", use_kernels=use_kernels,
                             sed_decay=decay)
        st = pair.state
        if use_kernels:     # a state of its own, equal to the plain one
            st = Pair(dataset, "sage", n_table=ds.n, j_max=ds.j_max).state
        runs.append((st, step))
    _, n_stale = kernel_step_parity(
        runs[0], runs[1], [port_batch(t) for t in (tups[0], tups[1], tups[0])],
        torch.Generator().manual_seed(1),
        dict.fromkeys(ops.kernel_launches(), 0))
    assert n_stale > 0


def test_train_step_updates_table_in_place():
    """The twin of test_donated_state_reuses_table_buffer: the step writes
    the table's storage in place, never a copy of the largest tensor."""
    ds, tups = batches("malnet")
    pair = Pair("malnet", "sage", n_table=ds.n, j_max=ds.j_max)
    _, step = pair.steps("gst_efd")
    st = pair.state
    ptrs = [t.data_ptr() for t in st.table]
    emb0 = st.table.emb.clone()
    gen = torch.Generator().manual_seed(0)
    for tup in (tups[0], tups[1], tups[0]):
        st, _ = step(st, port_batch(tup), gen)
    assert [t.data_ptr() for t in st.table] == ptrs
    assert not torch.equal(st.table.emb, emb0)
    assert int(st.table.age.max()) == 2 and bool(st.table.initialized.any())
