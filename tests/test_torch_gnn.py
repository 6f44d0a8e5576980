"""The port's GNN encoders and heads against the JAX package's.

Parameters are initialised by JAX and carried over with
``load_jax_params``; inputs are the JAX package's own padded segments.
Tolerance: f32 1e-5 (tests/test_fused_path.py:48).
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import gst as JG  # noqa: E402
from repro.graphs import data as JD  # noqa: E402
from repro.graphs.batching import segment_dataset  # noqa: E402
from repro.graphs.gnn import GNNConfig as JGNNConfig  # noqa: E402
from repro.graphs.gnn import encode_segments as jax_encode  # noqa: E402
from repro.graphs.gnn import gnn_init as jax_gnn_init  # noqa: E402
from repro_torch.core import gst as G  # noqa: E402
from repro_torch.graphs.gnn import (GNNConfig, encode_segments, gnn_init,  # noqa: E402
                                    load_jax_params)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.common import dense_init  # noqa: E402

HID = 16


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def seg_inputs():
    graphs = JD.make_malnet_like(n_graphs=3, comm_range=(3, 5),
                                 comm_size_range=(10, 20), seed=4)
    ds = segment_dataset(graphs, max_seg_nodes=24)
    si = ds.seg_inputs(np.arange(ds.n))
    # flatten (graphs, J) into one batch of segments
    return {k: v.reshape((-1,) + v.shape[2:]) for k, v in si.items()}


def _port_gnn(backbone, use_kernels, jparams):
    cfg = GNNConfig(backbone=backbone, n_feat=8, hidden=HID,
                    use_kernels=use_kernels)
    module = gnn_init(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, load_jax_params(module, _np_tree(jparams))


@pytest.mark.parametrize("backbone,use_kernels", [
    ("gcn", False), ("gcn", True), ("sage", False), ("sage", True),
    ("gps", False)])
def test_encode_segments_matches_jax(seg_inputs, backbone, use_kernels):
    jcfg = JGNNConfig(backbone=backbone, n_feat=8, hidden=HID,
                      use_pallas=use_kernels)
    jparams = jax_gnn_init(jax.random.key(1), jcfg)
    want = np.asarray(jax_encode(jparams, jcfg, {k: jnp.asarray(v)
                                                 for k, v in seg_inputs.items()}))
    cfg, module = _port_gnn(backbone, use_kernels, jparams)
    ops.reset_kernel_launches()
    with torch.no_grad():
        got = encode_segments(module, cfg, {k: torch.from_numpy(v)
                                            for k, v in seg_inputs.items()})
    assert ops.kernel_launches()["segment_spmm_batched"] == 0   # CPU: plain
    assert got.shape == (seg_inputs["x"].shape[0], HID)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backbone", ["gcn", "sage"])
def test_kernel_path_matches_plain_path(seg_inputs, backbone):
    """_encode_batched (GCN norm folded into the edge weights, SAGE degree
    clamp) computes _encode_one's function."""
    jparams = jax_gnn_init(jax.random.key(2), JGNNConfig(backbone=backbone,
                                                         hidden=HID))
    si = {k: torch.from_numpy(v) for k, v in seg_inputs.items()}
    outs = []
    for use_kernels in (False, True):
        cfg, module = _port_gnn(backbone, use_kernels, jparams)
        outs.append(module(si).detach())
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-5, atol=1e-5)


def test_parameter_names_follow_jax_paths():
    cfg = GNNConfig(backbone="sage", hidden=HID)
    names = {n for n, _ in gnn_init(cfg, torch.Generator(), "cpu")
             .named_parameters()}
    assert {"pre.0.w", "pre.0.b", "pre.0.prelu.a", "mp.1.w_self",
            "mp.1.w_nbr", "mp.0.prelu.a", "post.0.w"} <= names


def test_load_jax_params_rejects_mismatch():
    cfg = GNNConfig(backbone="gcn", hidden=HID)
    module = gnn_init(cfg, torch.Generator(), "cpu")
    tree = _np_tree(jax_gnn_init(jax.random.key(0),
                                 JGNNConfig(backbone="sage", hidden=HID)))
    with pytest.raises(KeyError):
        load_jax_params(module, tree)
    tree = _np_tree(jax_gnn_init(jax.random.key(0),
                                 JGNNConfig(backbone="gcn", hidden=2 * HID)))
    with pytest.raises(ValueError):
        load_jax_params(module, tree)


@pytest.mark.parametrize("mode", ["mlp", "segment_sum"])
def test_head_apply_matches_jax(mode):
    jhead = JG.head_init(jax.random.key(3), HID, 5, mode)
    head = load_jax_params(
        G.head_init(HID, 5, mode, torch.Generator(), "cpu"), _np_tree(jhead))
    h = np.random.default_rng(0).normal(size=(7, HID)).astype(np.float32)
    want = np.asarray(JG.head_apply(jhead, jnp.asarray(h), mode))
    got = G.head_apply(head, torch.from_numpy(h), mode).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_dense_init_bounds_and_std():
    d_in, d_out = 256, 512
    w = dense_init(d_in, d_out, torch.Generator().manual_seed(0))
    assert w.shape == (d_in, d_out) and w.dtype == torch.float32
    assert float(w.abs().max()) <= 2.0 / math.sqrt(d_in)
    # a unit normal cut at ±2 has std 0.8796 (the same law as JAX's
    # truncated_normal(-2, 2)); 131072 draws pin it to well within 2%
    want = 0.8796 / math.sqrt(d_in)
    assert abs(float(w.std()) / want - 1.0) < 0.02
    jw = np.asarray(jax.random.truncated_normal(jax.random.key(0), -2.0, 2.0,
                                                (d_in, d_out)))
    assert abs(float(jw.std()) / 0.8796 - 1.0) < 0.02
    again = dense_init(d_in, d_out, torch.Generator().manual_seed(0))
    assert torch.equal(w, again)
