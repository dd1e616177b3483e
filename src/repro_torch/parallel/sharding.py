"""Logical-axis sharding rules → specs and DTensor placements, ported from
the reference's ``repro/parallel/sharding.py``.

Every parameter carries a tuple of logical axis names (``Model.logical_axes``,
built by the same code path that builds the arrays). Rules map logical axes
to mesh axes; a dim whose size the mesh axis does not divide stays
replicated, and a >= 2-D leaf left without ``model`` falls back to the best
divisible other dim (row-parallel). A spec is a plain tuple with one entry
per dim: a mesh-axis name, a tuple of them, or None (replicated).

The port keeps a layer group's layers as separate leaves where the
reference stacks them under a leading ``layers`` dim. A leaf inside a layer
group's list is specced as the reference's stacked leaf (``layers``
prepended, never sharded) with that first entry dropped, so the port's
specs equal the reference's. ZeRO specs are taken on the port's own leaf.

ZeRO: optimizer-state specs additionally shard the largest replicated dim
over the data axes (``zero_spec``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

# logical axis -> mesh axis (None = replicate)
DEFAULT_RULES: dict[Optional[str], Optional[str]] = {
    "vocab": "model",
    "heads": "model",
    "kv": "model",
    "mlp": "model",
    "experts": "model",
    "expert_mlp": None,  # deepseek-v2 overrides to 'data' (2D expert sharding)
    "ssm_inner": "model",
    "ssm_heads": None,
    "lora": None,
    "embed": None,
    "layers": None,
    None: None,
}


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` (or of anything whose
    ``shape`` is already that dict, as the tests' stand-in meshes)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def axes_size(entry, shape: dict) -> int:
    """Ranks a spec entry (an axis name or a tuple of them) spans."""
    n = 1
    for a in entry if isinstance(entry, tuple) else (entry,):
        n *= shape[a]
    return n


def rules_for(cfg) -> dict:
    rules = dict(DEFAULT_RULES)
    for k, v in getattr(cfg, "sharding_rules", ()) or ():
        rules[k] = v
    return rules


# fallback priority when the preferred dim is not divisible by the mesh axis:
# shard a contracted/output dim instead — row-parallel style. Order matters:
# prefer the large embedding/hidden dims.
_FALLBACK_ORDER = ("embed", "mlp", "vocab", "ssm_inner", "lora")


def spec_for(axes: Tuple[Optional[str], ...], shape: Tuple[int, ...], rules: dict, mesh) -> tuple:
    sizes = mesh_shape(mesh)
    parts: list = []
    used: set = set()
    for ax_name, dim in zip(axes, shape):
        mesh_ax = rules.get(ax_name)
        if mesh_ax is None or mesh_ax in used:
            parts.append(None)
            continue
        size = sizes[mesh_ax]
        if dim % size != 0 or dim < size:  # shards must be exact
            parts.append(None)
            continue
        parts.append(mesh_ax)
        used.add(mesh_ax)
    # Fallback: a >=2D param that ended up unsharded on `model` (awkward head
    # counts, odd vocabs) gets `model` on the best divisible alternative dim
    # instead of being replicated.
    if "model" not in used and len(shape) >= 2:
        n_model = sizes.get("model", 1)

        def priority(i: int) -> tuple:
            name = axes[i]
            try:
                rank = _FALLBACK_ORDER.index(name)
            except ValueError:
                rank = len(_FALLBACK_ORDER)
            return (rank, -shape[i])

        for i in sorted(range(len(shape)), key=priority):
            if parts[i] is None and shape[i] % n_model == 0 and shape[i] >= n_model:
                if axes[i] == "layers":
                    continue  # never shard the layer dim
                parts[i] = "model"
                break
    return tuple(parts)


def param_specs(abstract: Any, axes_tree: Any, rules: dict, mesh) -> Any:
    """Spec tree matching the abstract-param tree; a list node is a layer
    group, specced as the reference's stacked leaf minus its ``layers``."""

    def walk(leaf, axes, stacked: int):
        if isinstance(leaf, dict):
            return {k: walk(leaf[k], axes[k], stacked) for k in leaf}
        if isinstance(leaf, list):
            return [walk(v, a, len(leaf)) for v, a in zip(leaf, axes)]
        if stacked:
            return spec_for(("layers", *axes), (stacked, *leaf.shape), rules, mesh)[1:]
        return spec_for(tuple(axes), tuple(leaf.shape), rules, mesh)

    return walk(abstract, axes_tree, 0)


def zero_spec(spec: tuple, shape: Tuple[int, ...], mesh, data_axes: Tuple[str, ...] = ("data",)
              ) -> tuple:
    """Add data-axis sharding to the largest still-replicated divisible dim
    (ZeRO partitioning of optimizer state / master weights)."""
    sizes = mesh_shape(mesh)
    n_data = axes_size(tuple(data_axes), sizes)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    # never double-map a mesh axis (e.g. deepseek-v2 expert_mlp already on data)
    already = set()
    for cur in parts:
        if cur is not None:
            already.update(cur if isinstance(cur, tuple) else (cur,))
    if any(a in already for a in data_axes):
        return tuple(parts)
    best, best_dim = -1, 0
    for i, (cur, dim) in enumerate(zip(parts, shape)):
        if cur is None and dim % n_data == 0 and dim > best_dim:
            best, best_dim = i, dim
    if best >= 0:
        parts[best] = tuple(data_axes) if len(data_axes) > 1 else data_axes[0]
    return tuple(parts)


def _map2(fn, specs: Any, tree: Any) -> Any:
    """``fn(spec, leaf)`` over a spec tree (tuple leaves) and a tree."""
    if isinstance(specs, dict):
        return {k: _map2(fn, specs[k], tree[k]) for k in specs}
    if isinstance(specs, list):
        return [_map2(fn, s, t) for s, t in zip(specs, tree)]
    return fn(specs, tree)


def zero_specs(spec_tree: Any, abstract: Any, mesh, data_axes: Tuple[str, ...] = ("data",)) -> Any:
    return _map2(lambda s, a: zero_spec(s, tuple(a.shape), mesh, data_axes), spec_tree, abstract)


def estimate_padding_waste(abstract: Any, spec_tree: Any, mesh) -> dict:
    """Bytes an uneven shard would pad (zero under the exact-divisibility
    rule above; kept for the roofline's honesty check)."""
    sizes = mesh_shape(mesh)
    total = padded = 0

    def one(spec, leaf):
        nonlocal total, padded
        nbytes = leaf.dtype.itemsize
        for dim in leaf.shape:
            nbytes *= int(dim)
        pbytes = nbytes
        for dim, ax in zip(leaf.shape, tuple(spec) + (None,) * (len(leaf.shape) - len(spec))):
            if ax is None:
                continue
            size = axes_size(ax, sizes)
            pbytes = pbytes // dim * (-(-dim // size) * size)
        total += nbytes
        padded += pbytes

    _map2(one, spec_tree, abstract)
    return {
        "logical_bytes": total,
        "padded_bytes": padded,
        "waste_frac": (padded - total) / max(total, 1),
    }


def placements(spec: tuple, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on each
    mesh dim that shards tensor dim ``i``, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in mesh.mesh_dim_names]
    for i, entry in enumerate(spec):
        for ax in () if entry is None else entry if isinstance(entry, tuple) else (entry,):
            out[mesh.mesh_dim_names.index(ax)] = Shard(i)
    return out


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the reference's ``NamedSharding``."""

    mesh: Any
    spec: tuple

    def placements(self) -> list:
        return placements(self.spec, self.mesh)


def shardings(spec_tree: Any, mesh) -> Any:
    """A tree of :class:`NamedSharding` over ``mesh`` for a spec tree."""
    return _map2(lambda s, _: NamedSharding(mesh, s), spec_tree, spec_tree)
