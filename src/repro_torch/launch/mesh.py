"""Production mesh construction. Port of ``repro/launch/mesh.py`` on
PyTorch's ``DeviceMesh``. A FUNCTION, not a module-level constant:
importing this module touches no device and no process group.

The production meshes have 256 or 512 ranks; the dry-run
(``launch/dryrun.py``) lays a cell out over them from ONE process. The
ranks are a ``"fake"`` process group (``torch.testing``'s ``FakeStore``):
every collective returns at once and moves nothing, which is all a
trace of rank 0's program needs. ``fake_world`` creates that group only
where none exists and destroys it on exit, so a process that already
holds a real group (a gloo test, a training run) is never disturbed.
"""
from __future__ import annotations

import contextlib

import torch.distributed as dist


@contextlib.contextmanager
def fake_world(world_size: int):
    """A default process group of ``world_size`` fake ranks (this process
    is rank 0) for the body of the ``with``. An existing default group of
    that size is used as it is and left alone; one of another size
    raises."""
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(
                f"a default process group of {dist.get_world_size()} ranks "
                f"exists; the mesh needs {world_size}")
        yield
        return
    # a private module of torch: where the installed torch lacks it, the
    # import fails loudly (there is no other way to lay out 256 ranks
    # from one process)
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def production_shape(multi_pod: bool = False):
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """Single pod: 16x16 = 256 ranks (data, model). Multi-pod: 2 pods of
    16x16 = 512 ranks (pod, data, model); the pod axis multiplies data
    parallelism and is the axis the dry-run proves out for cross-pod
    collectives. Needs a default group of that many ranks: run it inside
    ``fake_world(256 or 512)``."""
    shape, axes = production_shape(multi_pod)
    return make_mesh(shape, axes, device_type=device_type)


def make_mesh(shape, axes, device_type="cuda"):
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no default process group; wrap the "
                           "call in launch.mesh.fake_world(...)")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


# NVIDIA H100 80GB HBM3 (SXM5, 700 W) constants used by the roofline
# analysis, under the reference's keys. They are NVIDIA's data-sheet
# figures, not measurements: dense bf16 on the tensor cores, HBM3 rate
# and capacity, and one direction of NVLink 4 (900 GB/s both ways). A
# 16-wide "model" axis spans two 8-GPU nodes, so across nodes the
# collective term is optimistic: that traffic rides the slower
# inter-node network, not NVLink.
HW = {
    "peak_flops_bf16": 989e12,   # per GPU
    "hbm_bw": 3.35e12,           # bytes/s per GPU
    "ici_bw": 450e9,             # bytes/s per GPU, one direction
    "hbm_bytes": 80e9,           # capacity per GPU
}
