"""The port's sharding rules and launch specs (``launch/sharding.py``,
``launch/specs.py``, ``launch/mesh.py``) against the JAX package's
(``src/repro/launch/``), on the production meshes' shapes.

The reference's rules read only ``mesh.shape`` and ``mesh.axis_names``,
so a ``jax.sharding.AbstractMesh`` stands in for its 256 or 512 devices;
the port's meshes are ``DeviceMesh``es over a fake group.

  * every leaf of every arch's full-size parameter tree gets the
    reference's spec on (16, 16) and (2, 16, 16), and the local shard
    shape of its ``DTensor`` placements is the reference's;
  * the divisibility fallback, ``cache_spec`` over every arch's decode
    caches (``seq_shard`` where the plan says so),
    ``head_aligned_overrides``;
  * ``decode_plan``, ``gst_geometry``, ``supports_shape`` and
    ``input_specs`` for every arch × shape.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from torch.distributed.tensor import Shard  # noqa: E402

import repro.launch.sharding as JSH  # noqa: E402
import repro.launch.specs as JSP  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES,  # noqa: E402
                                      get_config)
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402

MESHES = {False: AbstractMesh((16, 16), ("data", "model")),
          True: AbstractMesh((2, 16, 16), ("pod", "data", "model"))}


def _jax_paths(tree):
    return {JSH._path_str(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_paths(tree):
    out = {}
    SH._tree_map_with_path(lambda p, leaf: out.__setitem__(p, leaf), tree)
    return out


@pytest.fixture(scope="module")
def trees():
    """arch -> (the reference's parameter shapes, the port's), by path."""
    out = {}
    for arch in ARCH_IDS:
        model = jbuild_model(jget_config(arch))
        jt = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.bfloat16))
        out[arch] = (_jax_paths(jt),
                     _port_paths(SP.param_shapes(get_config(arch))))
    return out


@pytest.fixture(params=[False, True], ids=["single", "multi"])
def meshes(request):
    """(the reference's abstract mesh, the port's fake DeviceMesh)."""
    with make_production_mesh(multi_pod=request.param, device="cpu") as m:
        yield MESHES[request.param], m


def _ref_local(jmesh, spec, shape):
    out = list(shape)
    for dim, entry in enumerate(spec):
        for name in (() if entry is None else
                     entry if isinstance(entry, tuple) else (entry,)):
            out[dim] //= jmesh.shape[name]
    return tuple(out)


def _dtensor_local(mesh, placements, shape):
    """The local shape DTensor gives this rank's shard (even split)."""
    out = list(shape)
    for d, p in enumerate(placements):
        if isinstance(p, Shard):
            out[p.dim] = math.ceil(out[p.dim] / mesh.size(d))
    return tuple(out)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_leaf_gets_the_reference_spec_and_shard_shape(arch, trees,
                                                            meshes):
    jmesh, mesh = meshes
    jt, pt = trees[arch]
    assert sorted(jt) == sorted(pt)
    for path, leaf in pt.items():
        shape = tuple(leaf.shape)
        assert shape == tuple(jt[path].shape), path
        want = JSH.spec_for_path(jmesh, path, shape)
        got = SH.spec_for_path(mesh, path, shape)
        assert got == tuple(want), path
        assert _dtensor_local(mesh, SH.placements(mesh, got), shape) == \
            _ref_local(jmesh, want, shape), path


def test_placements_split_fsdp_pod_major(meshes):
    _, mesh = meshes
    spec = SH.spec_for_path(mesh, "runs/0/attn/wq", (4, 2048, 2048))
    pl = SH.placements(mesh, spec)
    if "pod" in mesh.mesh_dim_names:
        assert spec == (None, ("pod", "data"), "model")
        assert pl == (Shard(1), Shard(1), Shard(2))
    else:
        assert spec == (None, "data", "model")
        assert pl == (Shard(1), Shard(2))


@pytest.mark.parametrize("path,shape", [
    ("experts/w_in", (3, 50, 77)), ("runs/0/attn/wq", (4, 250, 512)),
    ("embed", (1000, 30)), ("lm_head", (30, 1000)), ("norm1/scale", (256,)),
    ("runs/0/mix/conv_w", (4, 24)), ("router", (16, 7)),
    ("experts/w_out", (8, 96, 100))])
def test_divisibility_fallback_matches(path, shape, meshes):
    jmesh, mesh = meshes
    assert SH.spec_for_path(mesh, path, shape) == tuple(
        JSH.spec_for_path(jmesh, path, shape))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_head_aligned_overrides_match(arch, trees, meshes, monkeypatch):
    jmesh, mesh = meshes
    cfg, jcfg = get_config(arch), jget_config(arch)
    want = JSH.head_aligned_overrides(jcfg, jmesh)
    got = SH.head_aligned_overrides(cfg, mesh)
    assert got == want
    monkeypatch.setattr(JSH, "OVERRIDES", want)
    for path, leaf in trees[arch][1].items():
        shape = tuple(leaf.shape)
        assert SH.spec_for_path(mesh, path, shape, got) == tuple(
            JSH.spec_for_path(jmesh, path, shape)), path


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
def test_cache_specs_match(arch, shape_name, meshes):
    jmesh, mesh = meshes
    cfg, jcfg = get_config(arch), jget_config(arch)
    shape = INPUT_SHAPES[shape_name]
    if not cfg.supports_shape(shape):
        # the reference skips it too: no cache to shard
        assert not jcfg.supports_shape(JSP.INPUT_SHAPES[shape_name])
        return
    plan = SP.decode_plan(cfg, shape)
    B = shape.global_batch
    model = jbuild_model(jcfg)
    jc = jax.eval_shape(lambda: model.init_cache(B, plan.cache_len,
                                                 jnp.bfloat16))
    if jcfg.is_encoder_decoder:
        x = jax.ShapeDtypeStruct((jcfg.num_layers, B, jcfg.encoder_seq_len,
                                  jcfg.num_kv_heads,
                                  jcfg.resolved_head_dim), jnp.bfloat16)
        jc = {"self": jc, "cross": (x, x)}
    want = {p: (tuple(leaf.shape), JSH.cache_spec(
        jmesh, p, tuple(leaf.shape), plan.seq_shard))
        for p, leaf in _jax_paths(jc).items()}
    pc = _port_paths(SP.cache_shapes(cfg, B, plan.cache_len, torch.bfloat16))
    got = {p: (tuple(leaf.shape), SH.cache_spec(mesh, p, tuple(leaf.shape),
                                                plan.seq_shard))
           for p, leaf in pc.items()}
    assert got.keys() == want.keys()
    for p in want:
        assert got[p][0] == want[p][0], p
        assert got[p][1] == tuple(want[p][1]), p


def test_seq_shard_targets_the_sequence_dim(meshes):
    jmesh, mesh = meshes
    for path, shape in (("0/ckv", (61, 1, 524288, 512)),
                        ("0/k", (4, 1, 524288, 8, 128))):
        got = SH.cache_spec(mesh, path, shape, seq_shard=True)
        assert got == tuple(JSH.cache_spec(jmesh, path, shape,
                                           seq_shard=True))
        assert got[2] is not None and got[1] is None


def test_batch_and_table_specs_match(meshes):
    jmesh, mesh = meshes
    for b, nd in ((256, 3), (32, 2), (1, 2), (24, 1)):
        assert SH.batch_spec(mesh, b, nd) == tuple(
            JSH.batch_spec(jmesh, b, nd))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plans_geometry_and_input_specs_match(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name, shape in INPUT_SHAPES.items():
        jshape = JSP.INPUT_SHAPES[name]
        assert cfg.supports_shape(shape) == jcfg.supports_shape(jshape)
        if shape.kind == "train":
            assert SP.gst_geometry(cfg, shape) == JSP.gst_geometry(jcfg,
                                                                   jshape)
        if shape.kind == "decode":
            assert SP.decode_plan(cfg, shape).__dict__ == \
                JSP.decode_plan(jcfg, jshape).__dict__
        got = SP.input_specs(cfg, name)
        want = JSP.input_specs(jcfg, name)

        def norm(tree):
            if isinstance(tree, dict):
                return {k: norm(v) for k, v in tree.items()}
            if hasattr(tree, "shape"):
                return (tuple(tree.shape),
                        str(tree.dtype).removeprefix("torch."))
            return tree

        assert norm(got) == norm(want), name
