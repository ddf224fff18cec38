"""Device meshes over the current process group.

Port of ``repro/launch/mesh.py``: the same axis names and shapes, as
``torch.distributed`` ``DeviceMesh``es.  Single pod = 16 × 16 ranks,
axes (data, model); multi-pod = 2 × 16 × 16, axes (pod, data, model).
The ``pod`` axis is the slow link between pods: in the CELU party-to-pod
mapping it carries the two parties (``core/pod_protocol.py``), elsewhere
it extends data parallelism.

The roofline constants are one NVIDIA H100 SXM's (the dry-run's three
terms, ``launch/dryrun.py``), one constant a term as in the reference.

Every builder needs an initialised process group whose world size is the
mesh's size (``launch/dist.py`` starts one on one machine).  The device
type is the caller's, or follows the group's backend: ``"cuda"`` under
NCCL, ``"cpu"`` under gloo.  Functions, not module constants: importing
this module touches no process group.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

# NVIDIA H100 SXM constants (per GPU) for the roofline terms, from
# NVIDIA's H100 data sheet (dense rates, no sparsity) and the DGX H100
# system's network spec
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bf16 tensor cores, dense
HBM_BW = 3.35e12                # bytes/s, HBM3
# bytes/s of one GPU's link off its node: a DGX H100 gives each GPU one
# 400 Gb/s ConnectX-7 port, 400e9 / 8 = 50e9 B/s.  A 16-wide mesh axis
# spans two 8-GPU NVLink domains, so a ring over it crosses that link,
# which is its slowest hop; NVLink's 900 GB/s a GPU holds only inside
# one node of eight.
LINK_BW = 50e9

SINGLE_POD_SHAPE = (16, 16)
MULTI_POD_SHAPE = (2, 16, 16)


def _device_type(device_type: Optional[str]) -> str:
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("a device mesh needs an initialised process "
                           "group (launch.dist.run_ranks starts one)")
    if device_type is not None:
        return device_type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: Optional[str] = None):
    """A ``shape`` mesh over ``axes`` (``jax.make_mesh``'s counterpart)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dt = _device_type(device_type)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh over axes {axes} needs "
                         f"{math.prod(shape)} ranks; the world has {world}")
    return init_device_mesh(dt, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    shape = MULTI_POD_SHAPE if multi_pod else SINGLE_POD_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_host_mesh(device_type: Optional[str] = None):
    """Every rank on the ``data`` axis, ``model`` of size 1: for smoke
    tests."""
    import torch.distributed as dist
    _device_type(device_type)
    return make_mesh((dist.get_world_size(), 1), ("data", "model"),
                 device_type)


def data_axes(mesh) -> tuple:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def make_fleet_mesh(n_devices: Optional[int] = None,
                    device_type: Optional[str] = None):
    """1-D ``("fleet",)`` mesh: the job axis of the fleet runner
    (``repro_torch.fleet``) splits over it, one contiguous block of jobs
    a rank.  ``n_devices`` defaults to the world size."""
    import torch.distributed as dist
    _device_type(device_type)
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    return make_mesh((n,), ("fleet",), device_type)


def fleet_job_sharding(mesh):
    """The placements that split a leading job axis over the fleet mesh
    (the reference's ``PartitionSpec("fleet")``)."""
    from ..sharding.rules import placements
    return placements(mesh, ("fleet",))
