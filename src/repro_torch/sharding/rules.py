"""Logical-axis sharding rules with divisibility-aware fallback (torch
counterpart of ``repro/sharding/rules.py``).

Every parameter, cache bank and activation of the model carries a tuple of
*logical* axis names (e.g. ``("layers", "embed", "heads", "head_dim")``).
This module maps those to a ``PartitionSpec`` of mesh-axis names given a
rule table, in priority order, dropping assignments that fail
divisibility or would reuse a mesh axis within one spec: the tables and
the algorithm are the JAX package's, so the two give the same spec for the
same leaf.  ``placements`` turns a spec into the DTensor placements of a
``torch.distributed`` ``DeviceMesh`` (``Shard(i)`` / ``Replicate()`` per
mesh dim), the part ``NamedSharding`` plays in JAX.

``constrain(x, axes)`` is the counterpart of
``jax.lax.with_sharding_constraint`` at the models' layer boundaries: the
identity unless an ``activation_sharding`` is active and ``x`` is a
DTensor, when it redistributes ``x`` to the spec's placements.  With no
sharder it is a global lookup and a return, so the serve tick pays
nothing for it.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

MeshAxes = Union[str, Tuple[str, ...]]

# (logical axis -> ordered candidate mesh-axis groups, priority)
# Lower priority number is assigned first, so it wins contested mesh axes.
Rule = Tuple[Tuple[MeshAxes, ...], int]


class PartitionSpec(tuple):
    """One mesh-axis entry per array dim (a name, a tuple of names over
    which the dim is split major to minor, or None), trailing Nones
    trimmed; a tuple, so that it compares with JAX's ``P`` as a tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"



def default_rules(*, fsdp: bool = True, multi_pod: bool = False,
                  seq_parallel: bool = True,
                  strategy: str = "tp") -> Dict[str, Rule]:
    """Rule tables.

    strategy="tp" (default): TP over "model", DP over "data" (x "pod"),
    FSDP param sharding over "data", sequence parallelism (residual
    activations sharded over "model" between TP regions; decode's seq=1
    falls back by divisibility).

    strategy="fsdp": no tensor parallelism — batch is sharded over
    ("data","model") jointly (256-way DP on the single-pod mesh) and
    parameters are ZeRO-3-sharded over the same axes; "pod" stays pure DP.
    """
    if strategy == "fsdp":
        dp2: Tuple[str, ...] = ("data", "model")
        # candidate groups: prefer 256-way ZeRO-3, fall back to 16-way
        fa: Tuple[MeshAxes, ...] = (("data", "model"), ("data",))
        return {
            "batch": (((dp2),), 0),
            "seq": ((), 50),
            "embed_act": ((), 50),
            "heads": ((), 40),
            "kv_heads": ((), 40),
            "head_dim": ((), 40),
            "qkv_in": (fa, 30),
            "ffn": ((), 40),
            "ffn_in": (fa, 30),
            "experts": ((("model",),), 5),
            "expert_ffn": ((), 40),
            "capacity": ((), 40),
            "vocab": ((), 40),
            "embed": (fa, 30),
            "ssm_inner": (fa, 30),
            "ssm_heads": ((), 40),
            "ssm_state": ((), 40),
            "ssm_head_dim": ((), 40),
            "lru": (fa, 30),
            "conv_w": ((), 50),
            "kv_seq": ((("model",),), 20),
            "layers": ((), 99),
            "stack": ((), 99),
        }
    if strategy != "tp":
        raise ValueError(f"strategy {strategy!r} not in ('tp', 'fsdp')")

    dp: Tuple[str, ...] = ("pod", "data") if multi_pod else ("data",)
    fsdp_axes: Tuple[MeshAxes, ...] = (("data",),) if fsdp else ()
    sp_axes: Tuple[MeshAxes, ...] = ((("model",),) if seq_parallel else ())
    return {
        # activations
        "batch": ((dp,), 0),
        "seq": (sp_axes, 45),
        "embed_act": ((), 50),
        # attention params
        "heads": ((("model",),), 10),
        "kv_heads": ((("model",),), 10),
        "head_dim": ((), 40),
        "qkv_in": (fsdp_axes, 30),        # fsdp shard of the non-TP dim
        "ffn": ((("model",),), 10),
        "ffn_in": (fsdp_axes, 30),
        "experts": ((("model",),), 5),    # EP first choice for MoE
        "expert_ffn": ((("model",),), 15),  # expert-TP fallback
        "capacity": ((("model",),), 25),  # data-parallel-inside-MoE fallback
        "vocab": ((("model",),), 10),
        "embed": (fsdp_axes, 30),
        # ssm / recurrent params
        "ssm_inner": ((("model",),), 10),
        "ssm_heads": ((("model",),), 12),
        "ssm_state": ((), 40),
        "ssm_head_dim": ((), 40),
        "lru": ((("model",),), 10),
        "conv_w": ((), 50),
        # kv cache (decode): prefer kv_heads, fall back to sequence sharding
        "kv_seq": ((("model",),), 20),
        # scan/stack dims are never sharded
        "layers": ((), 99),
        "stack": ((), 99),
    }


def spec_for(axes: Sequence[Optional[str]], shape: Sequence[int],
             mesh_shape: Dict[str, int],
             rules: Dict[str, Rule]) -> PartitionSpec:
    """Build a PartitionSpec for one array.

    Dims are assigned in ascending rule priority; a mesh axis is used at most
    once per spec; assignments failing divisibility fall through to the next
    candidate group (or None).
    """
    if len(axes) != len(shape):
        raise ValueError(f"axes {tuple(axes)} vs shape {tuple(shape)}")
    order = sorted(
        range(len(axes)),
        key=lambda i: rules.get(axes[i], ((), 100))[1] if axes[i] else 100,
    )
    assigned: list = [None] * len(axes)
    used: set = set()
    for i in order:
        name = axes[i]
        if not name or name not in rules:
            continue
        candidates, _ = rules[name]
        for group in candidates:
            group_t = (group,) if isinstance(group, str) else tuple(group)
            if not group_t:
                continue
            if any(g in used or g not in mesh_shape for g in group_t):
                continue
            n = 1
            for g in group_t:
                n *= int(mesh_shape[g])
            if n <= 1 or shape[i] % n != 0:
                continue
            assigned[i] = group_t[0] if len(group_t) == 1 else group_t
            used.update(group_t)
            break
    while assigned and assigned[-1] is None:
        assigned.pop()
    return PartitionSpec(*assigned)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def tree_specs(axes_tree, shape_tree, mesh, rules: Dict[str, Rule]):
    """Map a (nested) dict of logical-axes tuples and a dict of the same
    keys holding tensors (or anything with ``.shape``) to PartitionSpecs.
    ``mesh`` is a ``DeviceMesh`` or a ``{axis: size}`` dict."""
    from repro_torch.launch.mesh import mesh_axis_sizes
    msizes = mesh if isinstance(mesh, dict) else mesh_axis_sizes(mesh)

    def walk(ax, sh):
        if _is_axes(ax):
            return spec_for(ax, tuple(sh.shape), msizes, rules)
        return {k: walk(ax[k], sh[k]) for k in ax}

    return walk(axes_tree, shape_tree)


def placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(i)`` where array dim i is split over that mesh axis, else
    ``Replicate()``.  A dim split over several mesh axes (``("data",
    "model")``, ``("pod", "data")``) is ``Shard(i)`` on each, major to
    minor as the spec lists them, which must be the mesh's own order (a
    spec from ``spec_for`` on the production rules always is)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        dims = [names.index(g) for g in group]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry!r} splits dim {i} in an "
                             f"order other than the mesh's {names}")
        for d in dims:
            out[d] = Shard(i)
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Sequence,
                mesh_shape: Dict[str, int]) -> Tuple[int, ...]:
    """The shape of one device's shard of an array of ``shape`` under
    ``spec`` (``spec_for`` only assigns dims that divide)."""
    out = list(shape)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        for g in ((entry,) if isinstance(entry, str) else entry):
            out[i] //= int(mesh_shape[g])
    return tuple(out)


# ---------------------------------------------------------------------------
# Activation sharding constraints.
#
# The models call ``constrain(x, logical_axes)`` at layer boundaries, where
# the JAX models call it; the dry run and the launchers install a sharder
# built from the active mesh and rules.  Outside one (unit tests, the
# engines, the one-device card paths) ``constrain`` is the identity, and
# so it is on any tensor that is not a DTensor.
# ---------------------------------------------------------------------------

_ACTIVATION_SHARDER = None


class activation_sharding:
    """Context manager installing an activation sharder for a mesh and
    rules: inside it ``constrain`` redistributes a DTensor to its logical
    axes' placements (the counterpart of ``with_sharding_constraint``)."""

    def __init__(self, mesh, rules: Dict[str, Rule]):
        from repro_torch.launch.mesh import mesh_axis_sizes
        from torch.distributed.tensor import DTensor
        msizes = mesh_axis_sizes(mesh)

        def sharder(x, axes):
            if not isinstance(x, DTensor):
                return x
            want = placements(spec_for(axes, tuple(x.shape), msizes, rules),
                              mesh)
            if tuple(x.placements) == want:
                return x
            return x.redistribute(mesh, want)

        self._sharder = sharder

    def __enter__(self):
        global _ACTIVATION_SHARDER
        self._prev = _ACTIVATION_SHARDER
        _ACTIVATION_SHARDER = self._sharder
        return self

    def __exit__(self, *exc):
        global _ACTIVATION_SHARDER
        _ACTIVATION_SHARDER = self._prev
        return False


def constrain(x, axes: Sequence[Optional[str]]):
    """Apply the active activation-sharding constraint (identity if none,
    or if ``x`` is not a DTensor)."""
    if _ACTIVATION_SHARDER is None:
        return x
    return _ACTIVATION_SHARDER(x, tuple(axes))
