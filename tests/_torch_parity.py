"""Shared set-up of the port's train-step parity tests: one batch of the JAX
package's own padded segments, JAX-initialised weights carried into the
port, and JAX's train-step draws replayed into the port's step."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import gst as JG
from repro.core import segment as jseg
from repro.core.embedding_table import init_table as jinit_table
from repro.graphs import batching as JBt
from repro.graphs import data as JD
from repro.graphs.gnn import GNNConfig as JGNNConfig
from repro.graphs.gnn import gnn_init as jgnn_init
from repro.graphs.gnn import make_encode_fn as jmake_encode_fn
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch.core import embedding_table as tbl
from repro_torch.core import gst as G
from repro_torch.graphs.gnn import GNNConfig, gnn_init, make_encode_fn
from repro_torch.models.common import flatten_tree, load_jax_params
from repro_torch.optim import make_optimizer

# the (head, loss, aggregation) of each dataset, as graphs/experiment.py
# sets them
TRACKS = {"malnet": ("mlp", "ce", "mean", 5),
          "tpugraphs": ("segment_sum", "pairwise_hinge", "sum", 1)}


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def batches(dataset, n_graphs=8, max_seg_nodes=32, batch_size=4):
    """(dataset, [batch tuples]) in the reference's batching, no shuffle."""
    make = JD.make_malnet_like if dataset == "malnet" else JD.make_tpugraphs_like
    ds = JBt.segment_dataset(make(n_graphs=n_graphs, seed=0),
                             max_seg_nodes=max_seg_nodes)
    tups = list(JBt.batch_iterator(ds, batch_size,
                                   rng=np.random.default_rng(0), shuffle=False))
    return ds, tups


def jax_batch(tup):
    return JG.GSTBatch({k: jnp.asarray(v) for k, v in tup[0].items()},
                       jnp.asarray(tup[1]), jnp.asarray(tup[2]),
                       jnp.asarray(tup[3]))


def port_batch(tup):
    return G.GSTBatch({k: torch.from_numpy(np.ascontiguousarray(v))
                       for k, v in tup[0].items()},
                      torch.from_numpy(tup[1]),
                      torch.from_numpy(tup[2].astype(np.int64)),
                      torch.from_numpy(np.asarray(tup[3])))


def jax_draws(rng, step, seg_valid, num_sampled):
    """The draws the JAX train step makes at ``step`` from ``rng``
    (src/repro/core/gst.py:248-250,279-280)."""
    r_sample, r_sed = jax.random.split(jax.random.fold_in(rng, step))
    sv = jnp.asarray(seg_valid)
    idx = jseg.sample_segments(r_sample, sv, num_sampled)
    u = jax.random.uniform(r_sed, sv.shape)
    return np.array(idx), np.array(u)


class Pair:
    """The same model in both packages: weights from JAX, Adam state at
    zeros on both sides, the same tables."""

    def __init__(self, dataset="malnet", backbone="sage", hidden=16,
                 n_table=8, j_max=4, lr=1e-2, seed=0, table_valid=None):
        self.head_mode, self.loss_kind, self.agg, n_out = TRACKS[dataset]
        self.jcfg = JGNNConfig(backbone=backbone, n_feat=8, hidden=hidden)
        key = jax.random.key(seed)
        self.jbb = jgnn_init(key, self.jcfg)
        self.jhead = JG.head_init(jax.random.fold_in(key, 1), hidden, n_out,
                                  self.head_mode)
        self.jopt = jmake_optimizer("adam", lr=lr)
        jtable = jinit_table(n_table, j_max, hidden)
        if table_valid is not None:
            # a table written before (random rows, every valid segment
            # initialized), so stale embeddings enter from the first step
            emb = np.random.default_rng(seed + 5).normal(
                size=jtable.emb.shape).astype(np.float32)
            jtable = jtable._replace(emb=jnp.asarray(emb),
                                     initialized=jnp.asarray(table_valid > 0))
        self.jstate = JG.TrainState(
            self.jbb, self.jhead, self.jopt.init((self.jbb, self.jhead)),
            jtable, jnp.zeros((), jnp.int32))

        self.cfg = GNNConfig(backbone=backbone, n_feat=8, hidden=hidden)
        bb = load_jax_params(gnn_init(self.cfg, torch.Generator(), "cpu"),
                             np_tree(self.jbb))
        head = load_jax_params(G.head_init(hidden, n_out, self.head_mode,
                                           torch.Generator(), "cpu"),
                               np_tree(self.jhead))
        self.opt = make_optimizer("adam", lr=lr)
        table = tbl.EmbeddingTable(*(torch.from_numpy(np.array(a))
                                     for a in jtable))
        self.state = G.TrainState(bb, head, None, table, 0)
        self.state = self.state._replace(
            opt_state=self.opt.init(G.train_params(self.state)))

    def steps(self, variant, *, use_pallas=False, use_kernels=None,
              num_sampled=1, sed_decay=0.0):
        """(jitted JAX train step, port train step) of one variant."""
        kw = dict(num_sampled=num_sampled, keep_prob=0.5,
                  head_mode=self.head_mode, loss_kind=self.loss_kind,
                  agg=self.agg, sed_decay=sed_decay)
        jcfg = JGNNConfig(backbone=self.jcfg.backbone, n_feat=8,
                          hidden=self.jcfg.hidden, use_pallas=use_pallas)
        jstep = jax.jit(JG.make_train_step(
            jmake_encode_fn(jcfg), self.jopt, JG.VARIANTS[variant],
            use_pallas=use_pallas, **kw))
        use_kernels = use_pallas if use_kernels is None else use_kernels
        cfg = GNNConfig(backbone=self.cfg.backbone, n_feat=8,
                        hidden=self.cfg.hidden, use_kernels=use_kernels)
        step = G.make_train_step(make_encode_fn(cfg), self.opt,
                                 G.VARIANTS[variant], use_kernels=use_kernels,
                                 **kw)
        return jstep, step


def named_params(state):
    """Port parameters by the JAX tree path of (backbone, head)."""
    out = {f"0.{n}": p for n, p in state.backbone.named_parameters()}
    out.update({f"1.{n}": p for n, p in state.head.named_parameters()})
    return out


def named_moments(state, which="mu"):
    names = list(named_params(state))
    return dict(zip(names, state.opt_state[which]))


def jax_named(tree):
    return dict(flatten_tree(np_tree(tree)))


def assert_tables_match(jtable, table):
    np.testing.assert_allclose(table.emb.numpy(), np.asarray(jtable.emb),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(table.age.numpy(), np.asarray(jtable.age))
    np.testing.assert_array_equal(table.initialized.numpy(),
                                  np.asarray(jtable.initialized))


@torch.no_grad()
def copy_jax_state(js, st):
    """Set the port's train state to JAX's, in place (parameters, Adam
    moments and count, table, step); returns the port state."""
    load_jax_params(st.backbone, np_tree(js.backbone))
    load_jax_params(st.head, np_tree(js.head))
    for which in ("mu", "nu"):
        want = jax_named(js.opt_state[which])
        for name, t in named_moments(st, which).items():
            t.copy_(torch.from_numpy(np.array(want[name])))
    for t, a in zip(st.table, js.table):
        t.copy_(torch.from_numpy(np.array(a)))
    opt_state = dict(st.opt_state, step=int(js.opt_state["step"]))
    return st._replace(opt_state=opt_state, step=int(js.step))
