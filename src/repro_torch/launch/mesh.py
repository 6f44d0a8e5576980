"""Production meshes of the port, as ``torch.distributed`` ``DeviceMesh``es.

Counterpart of ``src/repro/launch/mesh.py``, with the same shapes and
axis names:

    single pod : (data=16, model=16)              — 256 cards
    multi-pod  : (pod=2, data=16, model=16)       — 512 cards

The reference forces 512 host devices for XLA.  The port builds the mesh
over a FAKE process group of 256 or 512 ranks, in which this process is
rank 0 and no collective moves data: enough to shard parameters as
``DTensor``s and trace one step on fake tensors (``launch/dryrun.py``).
A default process group is process-wide, so the meshes are context
managers that create the group on entry and destroy it on exit, and they
refuse to run beside a group that is already initialised.  Nothing here
acts at import.

The multi-pod mesh's ``DTensor``s live on :func:`dtensor_mesh`, a
(pod·data, model) mesh over the same ranks: the reference's FSDP axes
('pod', 'data') always shard a tensor dim together, pod-major, which is
one flattened mesh dim's split (torch 2.11's DTensor refuses an index
into a dim sharded over two mesh dims; 2.13's redistribute planner
searches its states through every dim's shard order).
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch import resolve_device

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}
# the name of the flattened ('pod', 'data') dim of dtensor_mesh
POD_DATA = "pod_data"


@contextmanager
def _group(backend: str, world_size: int) -> Iterator[None]:
    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialised "
                           "in this process; a mesh of the dry run needs "
                           "its own")
    dist.init_process_group(backend, store=dist.HashStore(),
                            world_size=world_size, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextmanager
def fake_mesh(shape: Sequence[int], axes: Sequence[str],
              device="cuda") -> Iterator[DeviceMesh]:
    """A ``shape`` mesh named ``axes`` over a fake group of prod(shape)
    ranks, this process rank 0, for the mesh's ``device`` type (``cuda``
    needs no card: the dry run's tensors are fake)."""
    # importing it registers the "fake" backend with torch.distributed
    import torch.testing._internal.distributed.fake_pg  # noqa: F401

    n = 1
    for s in shape:
        n *= int(s)
    with _group("fake", n):
        yield init_device_mesh(torch.device(device).type, tuple(shape),
                               mesh_dim_names=tuple(axes))


@contextmanager
def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> Iterator[DeviceMesh]:
    """The (16, 16) ("data", "model") mesh, or with ``multi_pod`` the
    (2, 16, 16) ("pod", "data", "model") one, over a fake group."""
    shape, axes = PRODUCTION[multi_pod]
    with fake_mesh(shape, axes, device) as mesh:
        yield mesh


@contextmanager
def make_debug_mesh(device="cuda") -> Iterator[DeviceMesh]:
    """The 1x1 mesh with the production axis names on the real ``device``
    (a group of one: NCCL on the card, gloo on the CPU)."""
    dev = resolve_device(device)
    with _group("nccl" if dev.type == "cuda" else "gloo", 1):
        yield init_device_mesh(dev.type, (1, 1),
                               mesh_dim_names=("data", "model"))


def dtensor_mesh(mesh) -> DeviceMesh:
    """The mesh a step's ``DTensor``s are placed on: ``mesh`` itself, or
    for a ("pod", "data", "model") mesh the (pod·data, model) mesh over
    the same ranks in the same order (row-major: rank pod·D·M + data·M +
    model is (pod·D + data)·M + model), made once a mesh."""
    if "pod" not in mesh.mesh_dim_names:
        return mesh
    if tuple(mesh.mesh_dim_names) != PRODUCTION[True][1]:
        raise ValueError(f"a pod mesh is {PRODUCTION[True][1]}, not "
                         f"{mesh.mesh_dim_names}")
    flat = getattr(mesh, "_pod_data_mesh", None)
    if flat is None:
        from torch._subclasses.fake_tensor import unset_fake_temporarily

        pod, data, model = mesh.shape
        with unset_fake_temporarily():   # the mesh's own rank tensors
            flat = init_device_mesh(mesh.device_type, (pod * data, model),
                                    mesh_dim_names=(POD_DATA, "model"))
        mesh._pod_data_mesh = flat
    return flat


def mesh_sizes(mesh) -> dict:
    """Axis name -> size (``jax.sharding.Mesh.shape``'s form)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def fsdp_axes(mesh) -> Tuple[str, ...]:
    """The batch/FSDP axes: ('pod','data') on multipod, ('data',) otherwise
    (('pod_data',) on :func:`dtensor_mesh`'s flattened mesh)."""
    return tuple(a for a in mesh.mesh_dim_names
                 if a in ("pod", "data", POD_DATA))


def model_axis(mesh):
    return "model" if "model" in mesh.mesh_dim_names else None
