"""Per-rank op counts of one run of a step: the torch counterpart of
``repro.roofline.hlo_cost``.

The reference parses the compiled per-device SPMD HLO. Torch compiles
nothing here: the port's steps run eagerly, op by op, so ``OpCounter`` is a
``TorchDispatchMode`` that watches one run of the step and counts, for this
rank alone:

  * dot FLOPs: ``mm``, ``addmm``, ``bmm``, ``baddbmm`` (``einsum``,
    ``matmul`` and ``linear`` reach these), ``mv``, ``addmv`` and ``dot`` at
    ``2·M·N·K``, as ``hlo_cost`` counts ``dot`` (nothing else: elementwise
    work is not counted there either);
  * bytes: the operands plus the results of every op, except views
    (``func.is_view``: ``view``, ``t``, ``expand``, ``split``, ...),
    ``_unsafe_view``, detaches, metadata queries and the ``empty``
    factories, which move nothing (``hlo_cost``'s ``_SKIP_BYTES_OPS``). In
    eager mode every op is a fusion boundary, so this is the traffic the
    step's kernels would move with no fusion at all; a collective adds its
    result twice (read and write), as there;
  * collectives (``_c10d_functional``'s, which DTensor issues, and
    ``_dtensor.shard_dim_alltoall``): kind, result bytes, group size and
    whether the group spans more than one pod of ``pod_size`` ranks;
  * memory: the bytes of every storage a counted op allocates, live until
    the storage is freed, and their peak (``peak_bytes``; with the
    arguments registered by ``track_args``, ``temp_bytes`` is the peak
    above them), with the number of live allocations at the peak.

Counts are rank 0's share: under DTensor the counter sees the ops that
DTensor runs on the local shards. It returns ``NotImplemented`` for an op
with DTensor operands, so DTensor's own dispatch runs it and issues the
local op and any redistribution's collectives, which come back through
this mode with local shapes. DTensor's own bookkeeping (sharding
propagation, cached after an op's first call, which also runs the op once
on global-shape fake tensors to learn its output's shape; the local shape
and offset arithmetic) is not counted, and runs with any fake mode set
aside: it reads small index tensors back.

The port's models loop in Python (layers, chunks, microbatches and local
steps all run), so there are no trip counts to correct: a count is of what
ran. A step built with ``launch.specs.build_cell`` carries
``meta["cost_multiplier"]`` for the reference's extrapolation; nothing here
multiplies by it.

    counter = OpCounter(pod_size=256, fake_mode=fake_mode)
    with fake_mode, counter:
        counter.track_args(args)
        out = step(*args)
    counter.flops, counter.bytes, counter.collectives, counter.temp_bytes
"""
from __future__ import annotations

import threading
import weakref
from typing import Dict, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                           FakeTensor, unset_fake_temporarily)
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.roofline.analysis import crosses_pods

_DOTS = {"mm", "addmm", "bmm", "baddbmm", "mv", "addmv", "dot", "vdot"}
_NO_BYTES = {"_unsafe_view", "detach", "alias", "lift_fresh", "empty",
             "empty_like", "empty_strided", "new_empty", "new_empty_strided",
             "wait_tensor", "resize_", "set_", "_local_scalar_dense",
             "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
             "is_same_size", "is_nonzero"}
#: functional collective name -> the reference's kind
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}

#: under a fake mode, an op without fake operands whose results each take
#: at most this many bytes runs for real (``OpCounter._maybe_real``)
REAL_BELOW = 16 << 20

_INTERNAL = threading.local()
_PATCH_LOCK = threading.Lock()
_PATCH = {"depth": 0, "orig": []}
#: DTensor's own bookkeeping: sharding propagation (its strategies, their
#: redistribution costs and a global-shape fake run of the op) and the
#: local shape / offset arithmetic, which runs on small index tensors
_DTENSOR_INTERNALS = (
    ("torch.distributed.tensor._sharding_prop", "ShardingPropagator",
     "propagate_op_sharding_non_cached"),
    ("torch.distributed.tensor._utils", None,
     "_compute_local_shape_and_global_offset"),
)


def _internal() -> bool:
    return getattr(_INTERNAL, "depth", 0) > 0


def _mark_internal(fn):
    """``fn`` run as DTensor bookkeeping: uncounted, and with any fake mode
    set aside, so the index tensors it reads back are real (and tiny)."""
    def marked(*args, **kwargs):
        _INTERNAL.depth = getattr(_INTERNAL, "depth", 0) + 1
        try:
            with unset_fake_temporarily():
                return fn(*args, **kwargs)
        finally:
            _INTERNAL.depth -= 1

    return marked


def _patch_dtensor_internals():
    """Mark ``_DTENSOR_INTERNALS`` (those this torch has) while a counter
    is entered; the last counter to exit restores them."""
    import importlib
    with _PATCH_LOCK:
        _PATCH["depth"] += 1
        if _PATCH["depth"] > 1:
            return
        for mod_name, cls_name, attr in _DTENSOR_INTERNALS:
            owner = importlib.import_module(mod_name)
            if cls_name is not None:
                owner = getattr(owner, cls_name)
            orig = owner.__dict__.get(attr)
            if orig is None:
                continue
            _PATCH["orig"].append((owner, attr, orig))
            setattr(owner, attr, _mark_internal(orig))


def _restore_dtensor_internals():
    with _PATCH_LOCK:
        _PATCH["depth"] -= 1
        if _PATCH["depth"] == 0:
            for owner, attr, orig in _PATCH["orig"]:
                setattr(owner, attr, orig)
            _PATCH["orig"] = []


def _is_dtensor_type(t) -> bool:
    return any(c.__name__ == "DTensor" for c in t.__mro__)


def _tensors(x) -> List[torch.Tensor]:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def dot_flops(name: str, args) -> int:
    """2·M·N·K of a dot op ``name`` (an aten packet name) on ``args``."""
    if name in ("mm", "addmm"):
        a, b = (args[0], args[1]) if name == "mm" else (args[1], args[2])
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    if name in ("bmm", "baddbmm"):
        a, b = (args[0], args[1]) if name == "bmm" else (args[1], args[2])
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if name in ("mv", "addmv"):
        a = args[0] if name == "mv" else args[1]
        return 2 * a.shape[0] * a.shape[1]
    return 2 * args[0].shape[0]                    # dot, vdot


def _group_ranks(group_name) -> Tuple[int, ...]:
    from torch.distributed import distributed_c10d as c10d
    pg = c10d._resolve_process_group(group_name)
    return tuple(c10d.get_process_group_ranks(pg))


class OpCounter(TorchDispatchMode):
    """Counts one rank's dot FLOPs, bytes, collectives and live memory over
    the ops run under it (module docstring). ``pod_size``: ranks a pod
    (None: one pod, nothing crosses)."""

    def __init__(self, pod_size: Optional[int] = None, fake_mode=None):
        super().__init__()
        self.pod_size = pod_size
        self.fake_mode = fake_mode
        self.flops = 0
        self.bytes = 0
        #: (kind, result bytes, group size, cross_pod), one per collective
        self.collectives: List[Tuple[str, int, int, bool]] = []
        self.flops_by_op: Dict[str, int] = {}
        self.n_ops = 0
        self.arg_bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.live_allocs = 0
        self.allocs_at_peak = 0
        self.n_allocs = 0
        self._live: Dict[int, int] = {}

    # ------------------------------------------------------------- memory
    def _freed(self, key: int) -> None:
        nb = self._live.pop(key, None)
        if nb is not None:
            self.live_bytes -= nb
            self.live_allocs -= 1

    def _track(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage live (once); returns its bytes, 0 when it
        was already counted."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return 0
        nb = st.nbytes()
        self._live[key] = nb
        weakref.finalize(st, self._freed, key)
        self.live_bytes += nb
        self.live_allocs += 1
        self.n_allocs += 1
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
            self.allocs_at_peak = self.live_allocs
        return nb

    def track_args(self, args) -> int:
        """Count the storages of ``args`` (a tree; DTensor leaves by their
        local shards) live as the step's arguments; returns their bytes."""
        nb = 0
        for t in _tensors(args):
            local = getattr(t, "_local_tensor", t)
            nb += self._track(local)
        self.arg_bytes += nb
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return nb

    @property
    def temp_bytes(self) -> int:
        """The peak of live bytes above the arguments."""
        return self.peak_bytes - self.arg_bytes

    # ----------------------------------------------------------- dispatch
    def __enter__(self):
        _patch_dtensor_internals()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _restore_dtensor_internals()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented          # DTensor runs it on local shards
        if _internal():
            return func(*args, **kwargs)
        if self.fake_mode is not None and not any(
                isinstance(t, FakeTensor) for t in _tensors((args, kwargs))):
            out = self._maybe_real(func, args, kwargs)
        else:
            out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        ns = func.namespace
        if ns == "prim" or name.startswith("sym_"):
            return out
        self.n_ops += 1
        if ns == "aten" and name in _DOTS:
            f = dot_flops(name, args)
            self.flops += f
            self.flops_by_op[name] = self.flops_by_op.get(name, 0) + f
        kind = _COLLECTIVES.get(name) if ns in ("_c10d_functional",
                                               "_dtensor") else None
        if kind is not None:
            res = _tensors(out)
            rbytes = sum(_nbytes(t) for t in res)
            group = args[-1] if isinstance(args[-1], str) else \
                kwargs.get("group_name")
            ranks = _group_ranks(group)
            self.collectives.append((kind, rbytes, len(ranks),
                                     crosses_pods(ranks, self.pod_size)))
            self.bytes += 2 * rbytes
        elif not (func.is_view or name in _NO_BYTES):
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
        if not func.is_view and not func._schema.is_mutable:
            for t in _tensors(out):
                self._track(t)
        return out

    def _maybe_real(self, func, args, kwargs):
        """An op with no fake operand (a factory, or arithmetic on real
        tensors) runs under the fake mode first; when each of its results
        is small, or it reads a value back, it runs again for real, so its
        values exist: DTensor's layout helpers index with such tensors and
        read them back, as can a model (decode's position). Large results
        stay fake."""
        try:
            out = func(*args, **kwargs)
        except DataDependentOutputException:
            out = None
        if out is not None and not all(_nbytes(t) <= REAL_BELOW
                                       for t in _tensors(out)):
            return out
        with unset_fake_temporarily():
            return func(*args, **kwargs)
