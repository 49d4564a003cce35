"""Logical-axis sharding rules (torch port of ``repro.dist.sharding``).

Model code names axes *logically* (``"batch"``, ``"seq"``, ``"embed"``,
``"vocab"``, ``"heads"``, ``"experts"``, ``"ff"``, ``"act_d"``) and calls
``constrain(x, spec)``; a process-global :class:`Rules` object (installed by
``launch/specs.py`` via ``set_rules``) lowers those names to mesh axes.
Without rules — every single-process run — ``constrain`` returns its
argument, so the same model code runs unsharded.

Layout policy (the reference's):
  - ``batch``   -> all batch mesh axes present (``("pod", "data")`` on the
                   multi-pod mesh, ``("data",)`` on one pod)
  - ``vocab`` / ``heads`` / ``experts`` / ``ff`` -> the ``model`` axis
  - ``act_d``   -> ``model`` only for FSDP archs
  - ``seq`` / ``embed`` -> replicated

``param_specs`` gives every weight a :class:`P`: the largest mesh-divisible
dim goes to ``model`` (trailing dims first on ties); FSDP archs
(``cfg.n_params() >= cfg.fsdp_threshold``) also shard one remaining dim
over the batch axes; leaves under ``2**16`` elements stay replicated. The
spec functions read only a mesh's axis names and sizes, so they run on an
abstract mesh (``launch.mesh.AbstractMesh``) as on a realised one.

On a realised mesh (a ``DeviceMesh``) a spec becomes DTensor placements
(``placements``): an axis named in a spec entry shards that tensor dim,
several axes in one entry shard it over those mesh dims in order, major
first (JAX's order), and a mesh dim no entry names is replicated. ``place``
turns a tree of tensors into DTensors leaf by leaf; ``constrain``
redistributes a DTensor to its spec.

A stacked layer leaf (``[L, ...]``, vlm's ``[G, per, ...]``) whose spec
shards a stack dim is realised with that dim's mesh axes moved to the
first later dim they divide that the spec leaves whole, or replicated
where there is none (``stack_placements``): reading one layer of a stack
sharded on the layer dim would gather the whole stack (torch 2.11 refuses
to unbind it at all), where this layout keeps each layer's share on every
rank and gathers one layer at a time. The specs stay the reference's;
only their realisation moves.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.tree import tree_from_items, tree_items

# A logical spec entry: a logical axis name, or None for "replicated dim".
LogicalSpec = Sequence[Optional[str]]


class P(tuple):
    """A partition spec: one entry per tensor dim, each a mesh axis name,
    a tuple of names (the dim sharded over all of them, major first) or
    ``None`` (replicated). ``P()`` is a replicated leaf of any rank."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + (tuple.__repr__(self) if len(self) != 1
                      else f"({self[0]!r})")


def _is_device_mesh(mesh) -> bool:
    return hasattr(mesh, "mesh_dim_names")


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size, in order, of an abstract mesh (``axis_names`` /
    ``shape``) or a ``DeviceMesh`` (``mesh_dim_names`` / ``shape``)."""
    if _is_device_mesh(mesh):
        return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    return {a: int(s) for a, s in dict(mesh.shape).items()}


@dataclasses.dataclass(frozen=True)
class Rules:
    """Resolved logical-axis -> mesh-axis mapping for one (cfg, shape,
    mesh)."""
    mesh: Any
    axes: Dict[str, Any]            # logical name -> mesh axis | tuple | None
    batch_axes: Tuple[str, ...]     # mesh axes the batch dim shards over
    shard_batch: bool = True
    fsdp: bool = False

    def logical(self, spec: LogicalSpec) -> P:
        """Lower a tuple of logical names (None = replicated) to a
        :class:`P`. Unknown names resolve to replicated, so model code may
        annotate axes the current mesh does not distribute."""
        return P(*(self.axes.get(name) if name is not None else None
                   for name in spec))

    def batch_size(self) -> int:
        sizes = mesh_axes(self.mesh)
        return math.prod(sizes[a] for a in self.batch_axes)


# ------------------------------------------------------------- global registry
_RULES: Optional[Rules] = None


def get_rules() -> Optional[Rules]:
    return _RULES


def set_rules(rules: Optional[Rules]) -> Optional[Rules]:
    """Install (or clear, with None) the process-global rules."""
    global _RULES
    _RULES = rules
    return rules


class use_rules:
    """Context manager form of set_rules: restores on exit."""

    def __init__(self, rules: Optional[Rules]):
        self.rules = rules
        self._saved: Optional[Rules] = None

    def __enter__(self) -> Optional[Rules]:
        self._saved = get_rules()
        set_rules(self.rules)
        return self.rules

    def __exit__(self, *exc):
        set_rules(self._saved)
        return False


# ------------------------------------------------------------------ resolution
def make_rules(cfg, shape, mesh) -> Rules:
    """Map logical axes to mesh axes for one arch family x input shape.

    The batch mapping drops mesh axes (pod first) until the global batch is
    divisible by the product of the remaining ones, so odd shapes degrade to
    fewer-way data parallelism. ``mesh``: an abstract mesh or a
    ``DeviceMesh``; ``shape`` anything with ``global_batch`` (or None)."""
    msh = mesh_axes(mesh)
    batch_axes = tuple(a for a in ("pod", "data") if a in msh)
    gb = getattr(shape, "global_batch", None)
    while batch_axes and gb is not None and gb % math.prod(
            msh[a] for a in batch_axes):
        batch_axes = batch_axes[1:]
    model = "model" if "model" in msh else None
    fsdp = cfg.n_params() >= cfg.fsdp_threshold
    axes = {
        "batch": batch_axes if batch_axes else None,
        "seq": None,
        "embed": None,
        "vocab": model,
        "heads": model,
        "experts": model,
        "ff": model,
        "act_d": model if fsdp else None,
    }
    return Rules(mesh=mesh, axes=axes, batch_axes=batch_axes,
                 shard_batch=bool(batch_axes), fsdp=fsdp)


# ------------------------------------------------------------------ placements
def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def placements(spec: Sequence, device_mesh) -> tuple:
    """A :class:`P` -> DTensor placements on ``device_mesh``, one per mesh
    dim: ``Shard(d)`` for the mesh dims that entry ``d`` names, in mesh
    order (an entry's axes must come in the mesh's order: the first is
    the major one, as in JAX), ``Replicate()`` for the rest."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(device_mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        idx = []
        for a in _entry_axes(entry):
            if a not in names:
                raise ValueError(f"spec {spec!r} names axis {a!r}, not in "
                                 f"the mesh's {names}")
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec!r} uses axis {names[i]!r} "
                                 f"twice")
            out[i] = Shard(dim)
    return tuple(out)


def stack_placements(spec: Sequence, shape: Sequence[int], device_mesh,
                     n_stack: int) -> tuple:
    """Placements of a leaf whose first ``n_stack`` dims stack layers: as
    ``placements(spec)``, except that the mesh axes of a stack dim move to
    the first later dim that their size divides and that ``spec`` leaves
    whole, and are replicated when there is none (small leaves: a
    ``[L, d]`` bias beside its model-sharded ``d``)."""
    if n_stack == 0:
        return placements(spec, device_mesh)
    sizes = mesh_axes(device_mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for s in range(min(n_stack, len(entries))):
        axes = _entry_axes(entries[s])
        if not axes:
            continue
        m = math.prod(sizes[a] for a in axes)
        for d in range(n_stack, len(shape)):
            if entries[d] is None and shape[d] % m == 0 and shape[d] >= m:
                entries[d] = entries[s]
                break
        entries[s] = None
    return placements(P(*entries), device_mesh)


def local_piece(full: torch.Tensor, device_mesh, plc) -> torch.Tensor:
    """This rank's share of ``full`` under placements ``plc`` (DTensor's
    chunking: uneven dims give the first ranks one more), copied out."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, offset = compute_local_shape_and_global_offset(
        full.shape, device_mesh, plc)
    idx = tuple(slice(o, o + n) for o, n in zip(offset, shape))
    return full[idx].clone()


def from_local(local: torch.Tensor, device_mesh, plc, shape):
    """A DTensor of global ``shape`` from this rank's piece."""
    from torch.distributed.tensor import DTensor
    shape = torch.Size(shape)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, device_mesh, plc, run_check=False,
                              shape=shape, stride=stride)


def place(tree, specs, device_mesh, *, n_stack: Callable = None,
          device=None):
    """A tree of tensors -> the same tree of DTensors on ``device_mesh``,
    leaf by leaf: each rank copies its share of a leaf to ``device`` (the
    mesh's device by default) and goes on to the next, so no leaf is moved
    whole. ``specs``: the matching tree of :class:`P`; ``n_stack(path)``:
    the leaf's stacked layer dims (``Model.stacked_dims``; none by
    default), realised by ``stack_placements``. Every rank must hold the
    same values (the same seeded draw, ``Model.init``'s)."""
    dev = _mesh_device(device_mesh) if device is None else device
    spec_of = dict(tree_items_p(specs))
    out = []
    for path, x in tree_items(tree):
        plc = stack_placements(spec_of[path], tuple(x.shape), device_mesh,
                               n_stack(path) if n_stack else 0)
        piece = local_piece(x, device_mesh, plc).to(dev)
        out.append((path, from_local(piece, device_mesh, plc, x.shape)))
    return tree_from_items(out)


class Placer:
    """Keeps this rank's share of each leaf while ``Model.init`` draws it.

    ``Model.init(seed, placer=Placer(...))`` draws the whole seeded stream
    on every rank, as a single process does, and hands each stacked layer
    to ``stack`` as soon as it is drawn: the rank copies out its share of
    every leaf of that layer and the layer's full tensors are freed before
    the next is drawn. ``finish`` cuts the unstacked leaves (embedding,
    head, norms) the same way and returns the DTensor tree, which holds
    the single-process model's values. ``abstract``: the params' shapes
    (``Model.abstract_params``); ``specs`` their :class:`P` tree;
    ``n_stack(path)``: the leaf's stacked layer dims."""

    def __init__(self, abstract, specs, device_mesh, n_stack: Callable,
                 device=None):
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset
        self.mesh = device_mesh
        self.device = _mesh_device(device_mesh) if device is None else device
        spec_of = dict(tree_items_p(specs))
        self.geom = {}
        for path, x in tree_items(abstract):
            shape = tuple(x.shape)
            plc = stack_placements(spec_of[path], shape, device_mesh,
                                   n_stack(path))
            local, offset = compute_local_shape_and_global_offset(
                shape, device_mesh, plc)
            self.geom[path] = (shape, plc, tuple(local), tuple(offset))
        self.drawn = set()

    def stack(self, path, counts, draw):
        """Draw ``prod(counts)`` layers in order (``draw()`` gives one
        layer's tree) -> the tree of this rank's stacked shares."""
        kept: Dict[tuple, list] = {}
        k = len(counts)
        for idx in itertools.product(*(range(c) for c in counts)):
            for sub, leaf in tree_items(draw()):
                _, _, local, off = self.geom[path + sub]
                if all(off[s] <= idx[s] < off[s] + local[s]
                       for s in range(k)):
                    cut = tuple(slice(o, o + n)
                                for o, n in zip(off[k:], local[k:]))
                    kept.setdefault(sub, []).append(
                        leaf[cut].to(self.device, copy=True))
                else:
                    kept.setdefault(sub, [])
        out = []
        for sub, pieces in kept.items():
            _, _, local, _ = self.geom[path + sub]
            self.drawn.add(path + sub)
            out.append((sub, torch.stack(pieces).reshape(local)))
        return tree_from_items(out)

    def finish(self, params):
        """The tree from ``Model.init`` -> DTensors: stacked shares as they
        are, every other leaf cut to this rank's share."""
        out = []
        for path, x in tree_items(params):
            shape, plc, _, _ = self.geom[path]
            if path not in self.drawn:
                x = local_piece(x, self.mesh, plc).to(self.device)
            out.append((path, from_local(x, self.mesh, plc, shape)))
        return tree_from_items(out)


def _mesh_device(device_mesh) -> torch.device:
    if device_mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device_mesh.device_type)


def tree_items_p(specs, prefix=()):
    """``tree_items`` over a tree whose leaves are :class:`P` (or tuples of
    DTensor placements)."""
    if _spec_leaf(specs) or not isinstance(specs, (dict, list, tuple)):
        return [(prefix, specs)]
    if isinstance(specs, dict):
        return [item for k in sorted(specs)
                for item in tree_items_p(specs[k], prefix + (k,))]
    return [item for i, t in enumerate(specs)
            for item in tree_items_p(t, prefix + (i,))]


def full(x):
    """A DTensor's whole value on every rank (``full_tensor()``); a plain
    tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def is_dtensor(x) -> bool:
    return type(x).__name__ == "DTensor"


def layout_context(tree):
    """DTensor's implicit replication when ``tree`` holds DTensors (the
    model's plain constants, iotas and masks then act as replicated), else
    nothing."""
    if any(is_dtensor(x) for _, x in tree_items(tree)):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        return implicit_replication()
    return contextlib.nullcontext()


def gather_batch_axes(tree):
    """FSDP's gather: each DTensor leaf of ``tree`` with its shards over
    the rules' batch axes replaced by replication (its model-axis shards
    kept). The models gather a layer's weights this way inside its
    checkpointed block, so a layer is whole over ``data`` only while it
    runs (and again in its recompute), and every matmul meets weights
    laid out for tensor parallelism beside batch-sharded activations.
    Without rules, or for plain tensors, ``tree`` comes back as it is."""
    rules = get_rules()
    items = tree_items(tree)
    if rules is None or not rules.batch_axes or not items or not any(
            is_dtensor(x) for _, x in items):
        return tree
    from torch.distributed.tensor import Replicate
    out = []
    for path, x in items:
        if is_dtensor(x):
            names = x.device_mesh.mesh_dim_names
            plc = tuple(Replicate() if names[i] in rules.batch_axes
                        and p.is_shard() else p
                        for i, p in enumerate(x.placements))
            if plc != tuple(x.placements):
                x = x.redistribute(x.device_mesh, plc)
        out.append((path, x))
    return tree_from_items(out)


def whole_dim(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``x`` with dim ``dim`` gathered: a DTensor sharded on it comes back
    replicated there (its other placements kept); anything else as it is.
    The norms and the loss reduce over their last dim; DTensor reduces a
    sharded dim to a partial sum whose backward it cannot always lay out,
    so they gather it first (a GSPMD lowering gathers such a dim too)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    d = dim % x.dim()
    plc = tuple(Replicate() if p.is_shard(d) else p for p in x.placements)
    return x if plc == tuple(x.placements) else x.redistribute(
        x.device_mesh, plc)


def like(ref, whole: torch.Tensor):
    """``whole`` (the same value on every rank) laid out as ``ref``: this
    rank's share as a DTensor when ``ref`` is one, else ``whole``."""
    if not is_dtensor(ref):
        return whole
    plc = ref.placements
    return from_local(local_piece(whole, ref.device_mesh, plc),
                      ref.device_mesh, plc, ref.shape)


def zeros_lead(ref, n: int, dtype=torch.float32):
    """Zeros ``[n, *ref.shape]`` laid out as ``ref`` with a replicated
    leading dim (per-pod EF residuals of a leaf)."""
    if not is_dtensor(ref):
        return torch.zeros((n,) + tuple(ref.shape), dtype=dtype,
                           device=ref.device)
    from torch.distributed.tensor import Shard
    plc = tuple(Shard(p.dim + 1) if isinstance(p, Shard) else p
                for p in ref.placements)
    local = torch.zeros((n,) + tuple(ref.to_local().shape), dtype=dtype,
                        device=ref.to_local().device)
    return from_local(local, ref.device_mesh, plc, (n,) + tuple(ref.shape))


def _spec_leaf(x) -> bool:
    from torch.distributed.tensor import Placement
    return isinstance(x, P) or (isinstance(x, tuple) and len(x) > 0 and all(
        isinstance(e, Placement) for e in x))


def pin(items, grads, shardings, n_stack: Optional[Callable] = None):
    """Gradients (one per leaf of ``items``, the params' ``tree_items``)
    redistributed to ``shardings``: a :class:`P` tree (stacked leaves
    realised by ``stack_placements`` with ``n_stack(path)``) or a tree of
    placements. Plain gradients pass as they are."""
    target = dict(tree_items_p(shardings))
    out = []
    for (path, p), g in zip(items, grads):
        if is_dtensor(g):
            t = target[path]
            if isinstance(t, P):
                t = stack_placements(t, tuple(p.shape), g.device_mesh,
                                     n_stack(path) if n_stack else 0)
            g = g.redistribute(g.device_mesh, t)
        out.append(g)
    return out


_LEAF_WHOLE_HOOK: Optional[Callable] = None


def set_leaf_whole_hook(hook: Optional[Callable]) -> Optional[Callable]:
    """Install ``hook(fn, inputs, outs_like)`` in place of ``leaf_whole``'s
    own gather for this process (None restores it); returns the previous
    hook. A rig that runs several ranks on one card installs one that
    merges each leaf on a single rank: four whole leaves and their merges
    would not fit the card beside each other."""
    global _LEAF_WHOLE_HOOK
    prev, _LEAF_WHOLE_HOOK = _LEAF_WHOLE_HOOK, hook
    return prev


def leaf_whole(fn, inputs, outs_like):
    """``fn`` on the whole values of ``inputs`` (DTensors, plain tensors or
    None), its outputs laid out as ``outs_like`` (a DTensor each, whose
    layout the output takes, or None: kept as it comes). This is how a
    leaf reaches the merge kernels under the layout: they take raw
    pointers, and a Top-K threshold is a selection over the whole leaf
    (GSPMD gathers an opaque custom call's operands the same way). Every
    rank gathers the inputs (``full_tensor()``) and runs ``fn``, unless a
    hook is installed (``set_leaf_whole_hook``). With no DTensor input
    this is ``fn(*inputs)``."""
    if not any(is_dtensor(x) for x in inputs):
        return fn(*inputs)
    if _LEAF_WHOLE_HOOK is not None:
        return _LEAF_WHOLE_HOOK(fn, inputs, outs_like)
    outs = fn(*[full(x) for x in inputs])
    return [o if r is None or o is None else like(r, o)
            for r, o in zip(outs_like, outs)]


# ------------------------------------------------------------------- constrain
def constrain(x: torch.Tensor, spec: LogicalSpec) -> torch.Tensor:
    """``x`` redistributed to ``spec`` under the installed rules, when
    ``x`` is a DTensor and the rules' mesh is a ``DeviceMesh``. Returns
    ``x`` itself without rules, when the rank mismatches the annotation
    (callers annotate the common layout; variant ranks pass through), and
    for a plain tensor (one device holds all of it)."""
    rules = get_rules()
    if rules is None or len(spec) != x.dim():
        return x
    if not is_dtensor(x) or not _is_device_mesh(rules.mesh):
        return x
    return x.redistribute(x.device_mesh,
                          placements(rules.logical(spec), x.device_mesh))


# ----------------------------------------------------------------- spec trees
def _axis_sizes(mesh, axis) -> int:
    msh = mesh_axes(mesh)
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(msh[a] for a in axis)
    return msh[axis]


def _leaf_param_spec(shape: Tuple[int, ...], size: int, mesh, model_axis,
                     dp_axes, fsdp: bool, min_size: int) -> P:
    """TP the largest model-divisible dim; FSDP one remaining dim."""
    if not shape or size < min_size:
        return P()
    spec: list = [None] * len(shape)
    if model_axis is not None:
        m = _axis_sizes(mesh, model_axis)
        best = -1
        for i in range(len(shape) - 1, -1, -1):  # prefer trailing dims on ties
            if shape[i] % m == 0 and shape[i] >= m and (
                    best < 0 or shape[i] > shape[best]):
                best = i
        if best >= 0:
            spec[best] = model_axis
    if fsdp and dp_axes:
        d = _axis_sizes(mesh, dp_axes)
        for i, s in enumerate(shape):
            if spec[i] is None and s % d == 0 and s >= d:
                spec[i] = dp_axes
                break
    return P(*spec)


def map_shapes(fn, tree):
    """``fn(shape)`` over the leaves of a tensor tree (a spec tree)."""
    return tree_from_items((path, fn(tuple(x.shape)))
                           for path, x in tree_items(tree))


def param_specs(cfg, params_abs):
    """:class:`P` tree for a parameter tree (abstract or concrete). Without
    rules every leaf is replicated."""
    rules = get_rules()
    if rules is None:
        return map_shapes(lambda _: P(), params_abs)
    model_axis = rules.axes.get("vocab")  # the TP axis (None if mesh lacks it)
    dp_axes = rules.batch_axes if rules.batch_axes else None
    return map_shapes(
        lambda s: _leaf_param_spec(s, math.prod(s), rules.mesh, model_axis,
                                   dp_axes, rules.fsdp, min_size=2 ** 16),
        params_abs)


def batch_specs(cfg, batch_abs):
    """Batch dict -> specs: dim 0 over the batch axes, rest replicated."""
    rules = get_rules()
    if rules is None:
        return map_shapes(lambda _: P(), batch_abs)
    return map_shapes(
        lambda s: rules.logical(("batch",) + (None,) * (len(s) - 1)),
        batch_abs)


def cache_specs(cfg, cache_abs):
    """Decode-cache specs: batch dim over the batch axes; KV-heads over
    ``model`` when divisible, else the sequence dim. Cache leaves carry a
    leading layer-stack dim ([L, B, S, Hkv, D]; vlm's groups add one more:
    [G, per, B, ...]), which stays replicated."""
    rules = get_rules()
    if rules is None:
        return map_shapes(lambda _: P(), cache_abs)
    model_axis = rules.axes.get("heads")
    m = _axis_sizes(rules.mesh, model_axis) if model_axis is not None else 1
    b_axes = rules.batch_axes if rules.shard_batch else None
    nb = _axis_sizes(rules.mesh, b_axes) if b_axes else 1

    def spec(shape) -> P:
        nd = len(shape)
        if nd < 2:
            return P()
        bi = 2 if cfg.family == "vlm" and nd >= 5 else 1
        if bi >= nd:
            return P()
        out: list = [None] * nd
        if b_axes and shape[bi] % nb == 0 and shape[bi] >= nb:
            out[bi] = b_axes
        if model_axis is not None and m > 1:
            # prefer the KV-heads dim; fall back to sequence sharding
            hi = next((i for i in range(nd - 1, bi, -1)
                       if shape[i] == cfg.n_kv_heads and shape[i] % m == 0),
                      None)
            if hi is not None:
                out[hi] = model_axis
            elif bi + 1 < nd and shape[bi + 1] % m == 0 and shape[bi + 1] >= m:
                out[bi + 1] = model_axis
        return P(*out)

    return map_shapes(spec, cache_abs)
