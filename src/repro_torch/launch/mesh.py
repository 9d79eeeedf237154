"""The production meshes (torch counterpart of ``repro/launch/mesh.py``).

``make_production_mesh`` is a FUNCTION (importing this module touches no
device or process-group state).  The single-pod mesh is 16x16 = 256 ranks
("data","model"); the multi-pod mesh is 2x16x16 = 512 ranks
("pod","data","model").  ``make_mesh_for`` generalizes to any device count
for elastic re-meshing (see ``train/elastic.py``).  Each builds an
``init_device_mesh`` on the current default process group, whose world
size must be the mesh's size: a one-rank group for the train launcher's
1x1 mesh, a fake group of 256 or 512 ranks for the dry run
(``fake_process_group``), one rank per device otherwise.  The serve
launcher reads only the ladder's axis sizes (``ladder_mesh_sizes``).

``process_group`` and ``fake_process_group`` open a default group for the
body of a ``with`` and destroy it on exit, so ``dist.is_initialized()``
is what it was before; a group that is already open is used as it is and
left open.  ``mesh_context`` makes a mesh the one ``current_mesh()``
returns, the part ``jax.set_mesh`` plays for the JAX launchers.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

_CURRENT_MESH = None


def _device_type() -> str:
    """The mesh device type of the default group's backend: "cpu" for
    gloo, "cuda" for NCCL and for the fake backend, whose mesh models the
    card's (the dry run's tensors stay on ``meta``; on a "cpu" mesh
    DTensor would lower a shard-to-shard redistribution to gloo's
    all-gather and chunk instead of the all-to-all a card's mesh runs)."""
    import torch.distributed as dist
    return "cpu" if dist.get_backend() == "gloo" else "cuda"


def make_mesh(shape, names):
    """An ``init_device_mesh`` of ``shape`` with axis ``names`` on the
    default group."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def mesh_shape_for(num_devices: int, *, model_parallelism: int = 16,
                   pods: int = 1):
    """(shape, axis names) of the largest (pod, data, model) mesh that
    fits ``num_devices`` devices."""
    model = model_parallelism
    while model > 1 and num_devices % model:
        model //= 2
    data = num_devices // (model * pods)
    if data < 1:
        raise ValueError(
            f"cannot build mesh: {num_devices} devices, model={model}, "
            f"pods={pods}")
    if pods > 1:
        return (pods, data, model), ("pod", "data", "model")
    return (data, model), ("data", "model")


def make_mesh_for(num_devices: int, *, model_parallelism: int = 16,
                  pods: int = 1):
    """Largest (pod, data, model) mesh that fits ``num_devices`` devices."""
    return make_mesh(*mesh_shape_for(num_devices,
                                 model_parallelism=model_parallelism,
                                 pods=pods))


def mesh_axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def current_mesh():
    """The mesh of the innermost ``mesh_context`` (None outside one)."""
    return _CURRENT_MESH


@contextlib.contextmanager
def mesh_context(mesh) -> Iterator[object]:
    """Make ``mesh`` the current mesh for the body (the launchers' one
    mesh-scoping entry point, as in the JAX package)."""
    global _CURRENT_MESH
    prev, _CURRENT_MESH = _CURRENT_MESH, mesh
    try:
        yield mesh
    finally:
        _CURRENT_MESH = prev


@contextlib.contextmanager
def process_group(backend: str, world_size: int = 1, rank: int = 0,
                  store=None) -> Iterator[None]:
    """A default process group of ``backend`` for the body, destroyed on
    exit; an open default group is used as it is and left open.  Without
    ``store`` a one-rank group rendezvouses in an in-process
    ``HashStore``."""
    import torch.distributed as dist
    if dist.is_initialized():
        yield
        return
    if store is None:
        if world_size != 1:
            raise ValueError("a group of more than one rank needs a store")
        store = dist.HashStore()
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def fake_process_group(world_size: int, rank: int = 0) -> Iterator[None]:
    """A fake default group of ``world_size`` ranks (torch's ``"fake"``
    backend: this process plays ``rank``, and a collective moves nothing
    and returns at once), destroyed on exit.  The backend is registered by
    importing torch's ``fake_pg`` module, the one place both supported
    torch versions define it."""
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError("a default process group is already open; the "
                           "fake group would replace it")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    with process_group("fake", world_size, rank, store=FakeStore()):
        yield


def one_device_group(device_type: str):
    """``process_group`` of one rank on NCCL (``device_type`` "cuda") or
    gloo (otherwise)."""
    return process_group("nccl" if device_type == "cuda" else "gloo", 1, 0)


def _print_mesh(n: int, sizes: dict, model_parallelism: int) -> None:
    print(f"devices={n} mesh={sizes} "
          f"(model_parallelism={model_parallelism})", flush=True)


@contextlib.contextmanager
def launcher_mesh(device_type: str) -> Iterator[tuple]:
    """The train launcher's mesh, built as the JAX launcher builds its
    own: a one-rank default group (NCCL on the card, gloo on the CPU)
    unless one is open, the mesh the elastic ladder picks for its world
    size (``train/elastic.remesh``), and the line ``devices=N mesh={...}
    (model_parallelism=M)`` printed.  Yields (mesh, MeshChoice); a group
    it opened is destroyed on exit."""
    import torch.distributed as dist
    from repro_torch.train.elastic import choose_mesh, remesh
    with one_device_group(device_type):
        n = dist.get_world_size()
        mesh, choice = remesh(n), choose_mesh(n)
        _print_mesh(n, mesh_axis_sizes(mesh), choice.model_parallelism)
        yield mesh, choice


def ladder_mesh_sizes(num_devices: int) -> dict:
    """{axis: size} of the mesh the elastic ladder picks for
    ``num_devices``, printed as ``launcher_mesh`` prints it, with no
    process group and no ``DeviceMesh``: the serve launcher's, where
    nothing reads a mesh."""
    from repro_torch.train.elastic import choose_mesh
    c = choose_mesh(num_devices)
    shape, names = mesh_shape_for(c.devices,
                                  model_parallelism=c.model_parallelism,
                                  pods=c.pods)
    sizes = dict(zip(names, shape))
    _print_mesh(num_devices, sizes, c.model_parallelism)
    return sizes


def require_unsharded(specs, what: str) -> None:
    """Raise unless every spec of the (nested) dict ``specs`` is empty:
    the launchers drive one device, where the rules shard nothing and the
    model keeps plain tensors (and the ctypes kernels)."""
    stack = [("", specs)]
    while stack:
        name, s = stack.pop()
        if isinstance(s, dict):
            stack.extend((f"{name}/{k}".lstrip("/"), v) for k, v in s.items())
        elif len(s):
            raise ValueError(
                f"{what}: {name} would be sharded as {tuple(s)}; the "
                f"launchers drive one device (a sharded state is the dry "
                f"run's, launch/dryrun.py)")
