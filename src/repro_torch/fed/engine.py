"""Flat-space compression/aggregation substrate and the whole-simulation
engine, and the per-leaf half for real models (torch port of
``repro.fed.engine``).

  * ``ClientUpdateSpec`` / ``spec_for`` — static description of the client
    update pipeline (strategy, global or block Top-K, kernel routing, OPWA
    constants);
  * ``make_masked_local_trainer`` — local SGD for a whole cohort at once,
    clients stacked on a leading ``[C, ...]`` axis, padded steps exact
    no-ops;
  * ``aggregate_updates`` — [C, n] stacked updates -> traced-k Top-K, EF,
    codec and the OPWA / weighted merge. With kernels on (CUDA tensors) the
    whole pipeline is the two Hopper kernels ``threshold_find`` +
    ``fused_merge`` (global Top-K) or the traced-k block compressor and the
    ``overlap_combine`` kernel (block Top-K); the plain path is the
    reference's jnp path;
  * ``sparsify_rows`` / ``densify_rows`` — the sparse (idx, val) row codec
    of the population client-state store;
  * ``make_sim_scan`` — the whole multi-round simulation: on the card one
    captured CUDA graph of the round, replayed once a round over
    device-resident plan rows (``SimScan``);
  * the per-leaf half for real models: ``make_model_local_trainer`` (local
    SGD one client at a time into preallocated ``[C, *leaf]`` deltas),
    ``compress_merge_leaf`` (one leaf's Top-K / EF / codec and merge; on
    CUDA tensors ``threshold_find`` + ``fused_merge`` on a ``[C, leaf_n]``
    view) and ``init_mesh_residuals``;
  * ``make_mesh_sim_scan`` — the real-model trajectory (``fl_train
    --engine scan``): on the card one captured CUDA graph of
    ``mesh_round.make_round_body``, replayed once a round over
    device-resident plan rows (``MeshScanProgram``).

Everything strategy-shaped is read from the capability record; this module
never matches strategy names.
"""
from __future__ import annotations

import collections
import gc
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import compression as comp
from repro_torch.core import opwa as opwa_mod
from repro_torch.core import strategies as strat_mod
from repro_torch.tree import tree_from_items, tree_items

#: ("sim_scan" | "pop_scan", strategy, with_overlap) -> simulations built by
#: ``make_sim_scan``: one a simulation, however many rounds it runs (the
#: reference's ``TRACE_COUNTS``)
BUILD_COUNTS: collections.Counter = collections.Counter()
#: the same keys -> CUDA graphs captured: one a simulation on the card, two
#: when it holds the Fig. 4 overlap round
CAPTURE_COUNTS: collections.Counter = collections.Counter()


# ------------------------------------------------------------------- spec
@dataclass(frozen=True)
class ClientUpdateSpec:
    """Static description of the per-client update pipeline: compress
    (traced-k Top-K / EF / codec) -> OPWA or weighted merge. Runtime
    quantities (ks, weights, residuals) stay arguments of the functions
    below."""
    strategy: str = "fedavg"
    cr: float = 0.1                # static CR* (the reference's field)
    block_topk: bool = False
    block_size: int = 8192
    gamma: float = 5.0
    overlap_d: int = 1
    use_kernel: bool = False       # resolved bool (never "auto")

    def __post_init__(self):
        strat_mod.get(self.strategy)   # config-time error, names listed

    @property
    def strat(self) -> strat_mod.Strategy:
        return strat_mod.get(self.strategy)

    @property
    def needs_residuals(self) -> bool:
        return self.strat.needs_residuals

    @property
    def use_megakernel(self) -> bool:
        # the two-kernel pipeline serves every global-top-k strategy at
        # per-client ks; block configs keep the traced-k block compressor
        # (per-block thresholds); codec strategies join iff they registered
        # a kernel_codec; dense strategies stay a single weighted sum
        return (self.use_kernel and not self.block_topk
                and self.strat.megakernel and self.strat.compresses)


def spec_for(acfg, device) -> ClientUpdateSpec:
    """AggregationConfig -> ClientUpdateSpec, with ``use_kernel`` resolved
    for ``device`` ("auto": kernels on CUDA, plain path on the CPU)."""
    return ClientUpdateSpec(
        strategy=acfg.strategy, cr=acfg.cr, block_topk=acfg.block_topk,
        block_size=acfg.block_size, gamma=acfg.gamma,
        overlap_d=acfg.overlap_d,
        use_kernel=comp.resolve_use_kernel(acfg.use_kernel, device))


def compress_batch_fn(spec: ClientUpdateSpec) -> Callable:
    """Batched traced-k compressor for the spec: [C, n], ks [C] ->
    Compressed (per block of ``block_size`` in block mode). A registered
    ``value_codec`` dequantizes the survivors, so downstream EF/merge code
    needs no codec branch."""
    if spec.block_topk:
        def base(u, ks):
            return comp.block_topk_compress_batch(u, ks,
                                                  block=spec.block_size)
    else:
        base = comp.topk_compress_batch
    codec = spec.strat.value_codec
    if codec is None:
        return base

    def compress(u, ks):
        c = base(u, ks)
        return comp.Compressed(codec(c.values, c.mask), c.mask)

    return compress


# ------------------------------------------------------------- flat <-> dict
def make_unflatten(params_template) -> Callable:
    """[n] flat -> a (nested) dict shaped like ``params_template``, in
    sorted-key order at every level (the reference's ravel order), each
    leaf in its template's dtype; [C, n] rows -> dict of [C, ...] (the
    inverse of ``flatten_client_trees``). A leaf whose dtype is the flat
    vector's is a view of ``flat``."""
    specs = [(path, tuple(leaf.shape), int(leaf.numel()), leaf.dtype)
             for path, leaf in tree_items(params_template)]

    def unflatten(flat: torch.Tensor):
        out, off = [], 0
        for path, shape, size, dtype in specs:
            leaf = flat[..., off:off + size].view(*flat.shape[:-1], *shape)
            out.append((path, leaf.to(dtype)))
            off += size
        return tree_from_items(out)

    return unflatten


def flatten_client_trees(deltas) -> torch.Tensor:
    """(nested) dict of [C, ...] tensors -> [C, n] f32 in sorted-key
    (ravel) order."""
    return torch.cat([leaf.reshape(leaf.shape[0], -1).to(torch.float32)
                      for _, leaf in tree_items(deltas)], dim=1)


# ------------------------------------------------- sparse EF residual codec
def sparsify_rows(rows: torch.Tensor, width: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[C, n] f32 -> (idx [C, width] int32, val [C, width] f32, overflow).

    The population client-state store's "topk_complement" residual layout:
    a stable argsort on the zero flag packs each row's nonzero coordinates
    first, in ascending index order; padding entries carry the zero values
    at their own coordinates, so ``densify_rows`` adds them back as exact
    no-ops. A denormal counts as zero, as on the reference's platforms
    (which flush f32 denormals). ``overflow`` (bool scalar) is True iff some
    row has more than ``width`` nonzeros."""
    mag = torch.abs(rows.to(torch.float32))
    zero = mag < torch.finfo(torch.float32).tiny    # NaN counts as nonzero
    order = torch.argsort(zero.to(torch.int8), dim=1, stable=True)[:, :width]
    val = torch.gather(rows, 1, order)
    overflow = ((~zero).sum(dim=1) > width).any()
    return order.to(torch.int32), val, overflow


def densify_rows(idx: torch.Tensor, val: torch.Tensor, n: int
                 ) -> torch.Tensor:
    """(idx [C, W] int32, val [C, W] f32) -> [C, n] f32, the inverse of
    ``sparsify_rows``: a scatter-add onto zeros, each stored value landing
    at its own coordinate (within a row the indices are distinct). A
    denormal that lands on a zero is flushed, as the reference's platforms
    add it (0 + denormal = 0 there)."""
    rows = torch.zeros((idx.shape[0], n), dtype=val.dtype, device=val.device)
    rows.scatter_add_(1, idx.to(torch.int64), val)
    return torch.where(torch.abs(rows) < torch.finfo(torch.float32).tiny,
                       torch.zeros_like(rows), rows)


# ----------------------------------------------------------- masked trainer
def make_masked_local_trainer(loss_fn: Callable, lr: float):
    """``local_train(params, batches, step_mask) -> (delta, last_loss)``.

    The whole cohort trains at once: every parameter gets a leading client
    axis ``[C, ...]`` and ``loss_fn`` (batched, e.g. ``torch.bmm``) returns
    per-client losses [C]. The gradient of their SUM is exact per client,
    since client c's loss depends on client c's copy alone. Steps with
    ``step_mask`` False are exact no-ops (``torch.where`` keeps the old
    values), so clients with fewer real steps match the ragged sequential
    loop. The reported loss is the pre-update loss of the last real step
    (per client).

    params: dict of unbatched tensors, shared by the cohort — or, with
    ``stacked=True``, dict of [C, ...] tensors, each client starting from
    its own row (the async engine's waves, each member at its own server
    version); batches: dict of [C, S, ...]; step_mask: bool [C, S]. Returns
    (delta dict of [C, ...] = params - final, losses [C]). A client's delta
    is the same either way when its start is the same.
    """
    def local_train(params, batches, step_mask, stacked: bool = False):
        c, n_steps = step_mask.shape
        if stacked:
            cur = {k: v.detach().clone() for k, v in params.items()}
        else:
            cur = {k: v.detach().unsqueeze(0).expand(c, *v.shape).clone()
                   for k, v in params.items()}
        last = torch.zeros((c,), dtype=torch.float32,
                           device=step_mask.device)
        for s in range(n_steps):
            live = {k: v.requires_grad_(True) for k, v in cur.items()}
            losses, _ = loss_fn(live, {k: b[:, s] for k, b in batches.items()})
            keys = list(live)
            grads = torch.autograd.grad(losses.sum(), [live[k] for k in keys])
            m = step_mask[:, s]
            with torch.no_grad():
                for key, g in zip(keys, grads):
                    p = live[key].detach()
                    keep = m.view((c,) + (1,) * (p.dim() - 1))
                    cur[key] = torch.where(keep, p - lr * g, p)
                last = torch.where(m, losses.detach(), last)
        with torch.no_grad():
            delta = {k: (params[k] if stacked else params[k].unsqueeze(0))
                     - cur[k] for k in cur}
        return delta, last

    return local_train


# -------------------------------------------------------- megakernel routing
def _aggregate_megakernel(spec: ClientUpdateSpec, updates: torch.Tensor,
                          w: torch.Tensor, ks: torch.Tensor,
                          residuals: Optional[torch.Tensor],
                          active: Optional[torch.Tensor]
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Two-kernel route: ``threshold_find`` (exact per-client thresholds)
    then ``fused_merge`` (EF, mask, codec, overlap counts, the OPWA mask and
    the weighted merge in one pass). Codec strategies use their registered
    ``kernel_codec`` stage with the scale from ``threshold_find``'s absmax."""
    codec = spec.strat.kernel_codec or "none"
    if spec.strat.overlap_weighted and not spec.needs_residuals:
        agg = opwa_mod.opwa_aggregate_traced_k(
            updates, ks, w, spec.gamma, spec.overlap_d, active=active,
            use_kernel=True)
        return agg, residuals
    from repro_torch.kernels import ops as kops
    agg, new_res = kops.megakernel_aggregate(
        updates, ks, w, residuals=residuals, active=active,
        opwa=spec.strat.overlap_weighted, gamma=spec.gamma,
        d=spec.overlap_d, codec=codec)
    return agg, (new_res if spec.needs_residuals else residuals)


# ------------------------------------------------------------ flat-space path
def aggregate_updates(spec: ClientUpdateSpec, updates: torch.Tensor,
                      weights: torch.Tensor, ks: torch.Tensor,
                      residuals: Optional[torch.Tensor] = None,
                      active: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Compress + merge stacked flat client updates.

    updates [C, n] f32; weights [C] (data fracs or Eq. 6 coefficients); ks
    [C] int retained counts; residuals [C, n] EF state (required iff the
    strategy carries EF); active optional bool [C] — inactive rows contribute
    nothing to the merge or the overlap counts and their residuals pass
    through unchanged.

    Returns (agg [n] f32, new_residuals | None).
    """
    w = weights.to(device=updates.device, dtype=torch.float32)
    ks = torch.as_tensor(ks, device=updates.device)
    strat = spec.strat
    if strat.needs_residuals and residuals is None:
        raise ValueError(f"{spec.strategy} needs residuals")
    if spec.use_megakernel:
        return _aggregate_megakernel(spec, updates, w, ks, residuals, active)

    compress = compress_batch_fn(spec)
    mask = None
    new_res = residuals

    if not strat.compresses:
        vals = updates
    elif strat.needs_residuals:
        c_obj, new_res = comp.ef_compress_batch(
            residuals, updates, ks, compress_batch=compress)
        vals, mask = c_obj.values, c_obj.mask
        if active is not None:
            new_res = torch.where(active[:, None], new_res, residuals)
    else:
        c_obj = compress(updates, ks)
        vals, mask = c_obj.values, c_obj.mask

    if active is not None:
        # padded rows are all-zero updates whose Top-K mask over zeros is
        # all-True (ties at the threshold) — force them out of the merge
        vals = vals * active[:, None]
        if mask is not None:
            mask = mask & active[:, None]

    if strat.overlap_weighted:
        agg = opwa_mod.opwa_aggregate(vals, mask, w, spec.gamma,
                                      spec.overlap_d,
                                      use_kernel=spec.use_kernel)
    else:
        agg = opwa_mod.weighted_sum(w, vals)
    return agg, new_res


# ------------------------------------------------------------ round body
def make_round_body(loss_fn: Callable, params_template, *, lr: float,
                    spec: ClientUpdateSpec, eta: float = 1.0,
                    make_batches: Optional[Callable] = None) -> Callable:
    """One FL round on a plan, in place — the body the fused round step
    (``round_step.make_round_step``) and the scan engines
    (``make_sim_scan``) share, so both run the same ops on the same
    shapes::

        body(flat [n] f32,               # UPDATED IN PLACE: w <- w - eta*agg
             residuals,                  # EF state, UPDATED IN PLACE: [C, n]
                                         # (or [P + 1, n] with ``cohort``);
                                         # unused without EF
             plan: {"step_mask" [C, S] bool, "active" [C] bool,
                    "weights" [C] f32, "ks" [C] int,
                    + what ``make_batches`` reads (default "batches"),
                    + "ks_overlap" [C] int when ``overlap``},
             overlap: bool,              # the Fig. 4 counts this round
             cohort=None)                # [C] int64 slot -> residuals row
        -> {"loss": mean over active slots of the last local losses
            [, "overlap_counts" [n] int32] + plan.get("ys_extra", {})}

    Masked local SGD for the cohort, ``flatten_client_trees``,
    ``aggregate_updates(..., active=)``, the server update and the
    residuals written back. Inactive (padded) slots contribute nothing;
    with ``cohort`` they write back what they read (a per-client matrix's
    sentinel row stays zero)."""
    unflatten = make_unflatten(params_template)
    local_train = make_masked_local_trainer(loss_fn, lr)
    get_batches = make_batches or (lambda p: p["batches"])
    ef = spec.needs_residuals

    def body(flat, res, p, overlap: bool, cohort=None):
        deltas, losses = local_train(unflatten(flat), get_batches(p),
                                     p["step_mask"])
        updates = flatten_client_trees(deltas)          # [C, n] f32
        active = p["active"]
        res_in = res.index_select(0, cohort) if cohort is not None else res
        agg, new_res = aggregate_updates(
            spec, updates, p["weights"], p["ks"],
            residuals=res_in if ef else None, active=active)
        if ef and cohort is not None:
            res.index_copy_(0, cohort,
                            torch.where(active[:, None], new_res, res_in))
        elif ef:
            res.copy_(new_res)
        flat.sub_(eta * agg)
        n_act = active.to(torch.int32).sum().clamp_min(1)
        ys = {"loss": torch.where(active, losses,
                                  torch.zeros_like(losses)).sum() / n_act}
        ys.update(p.get("ys_extra", {}))
        if overlap:
            # Fig. 4 instrumentation: global top-k masks on the RAW deltas
            masks = comp.topk_compress_batch(
                updates, p["ks_overlap"],
                use_kernel=spec.use_kernel).mask & active[:, None]
            ys["overlap_counts"] = opwa_mod.overlap_counts(masks)
        return ys

    return body


# ---------------------------------------------------------- scanned simulation
#: xs entries the host reads itself: the events a captured round cannot
#: hold (an eval snapshot, an EF reset, the Fig. 4 overlap round)
HOST_KEYS = ("eval_write", "eval_slot", "reset_ef", "overlap_round")
#: eager warm-up rounds before each capture, on scratch copies of the state
WARMUP = 2


def _map_tree(fn: Callable, tree):
    """``fn`` over the leaves of a (nested) dict."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


class CapturedRound:
    """One round captured into a ``CUDAGraph``, for the scan programs.

    ``warm_up`` (or None) runs first on the capture's side stream: the
    first calls load the kernels, cuBLAS and the autograd engine and fill
    the allocator, none of which a capture may do. The cached blocks are
    then released, so the warm-up's and the graph's private pool are not
    held together, and ``step`` is captured (into ``pool`` when given,
    ``generator``'s state registered with the graph). ``threshold_find.
    reads_log`` is off throughout, and the kernel launches the capture
    records are added to their wrappers' counters at each ``replay()``.
    ``warm_up_s`` and ``capture_s`` are the two phases' host walls. A
    failed capture raises."""

    def __init__(self, step: Callable, warm_up: Optional[Callable], device,
                 *, pool=None, generator: Optional[torch.Generator] = None):
        from repro_torch.kernels import build
        from repro_torch.kernels.threshold_find import threshold_find
        reads_log, threshold_find.reads_log = threshold_find.reads_log, None
        try:
            t0 = time.perf_counter()
            stream = torch.cuda.Stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
            if warm_up is not None:
                with torch.cuda.stream(stream):
                    warm_up()
            torch.cuda.synchronize(device)
            self.warm_up_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            gc.collect()
            torch.cuda.empty_cache()
            self.graph = torch.cuda.CUDAGraph()
            if generator is not None:
                self.graph.register_generator_state(generator)
            with build.captured_launches() as per_replay:
                with torch.cuda.graph(self.graph, pool=pool, stream=stream):
                    step()
            torch.cuda.synchronize(device)
            self.capture_s = time.perf_counter() - t0
        finally:
            threshold_find.reads_log = reads_log
        self.launches = dict(per_replay)

    def replay(self) -> None:
        self.graph.replay()
        for wrapper, n in self.launches.items():
            wrapper.launches += n


class SimScan:
    """The whole-simulation program of ``make_sim_scan``.
    ``compile(flat, residuals, evals, xs)`` prepares it for those buffers
    (on the card: xs copied once, the round captured) and returns a
    ``ScanProgram``; calling that runs every round. ``sim(flat, residuals,
    evals, xs)`` does both."""

    def __init__(self, round_fn: Callable, spec: ClientUpdateSpec,
                 with_overlap: bool, kind: str, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        self.round_fn = round_fn
        self.spec = spec
        self.with_overlap = with_overlap
        self.kind = kind
        self.device = device
        self.generator = generator

    def compile(self, flat, residuals, evals, xs) -> "ScanProgram":
        return ScanProgram(self, flat, residuals, evals, xs)

    def __call__(self, flat, residuals, evals, xs):
        return self.compile(flat, residuals, evals, xs)()


class ScanProgram:
    """One simulation's rounds, bound to its ``flat`` [n], ``residuals``
    and ``evals`` [E, n] buffers, which it updates in place.

    The plan rows ``xs`` (numpy or tensors, [R, ...]) are put on the device
    once. A device-resident round counter picks each round's row inside the
    round, and the round advances it, so a round takes no host-to-device
    copy. On the card the round is captured once into a ``CUDAGraph`` (the
    body first warmed up on a side stream on scratch copies of the state,
    as PyTorch's whole-network capture requires) and R rounds are R
    replays; with an overlap round a second graph, sharing the first's
    memory pool, holds the round with the Fig. 4 counts. The graphs run the
    same kernels as an eager round, so replays are bit-equal to it. On the
    CPU the same round runs eagerly, once a row.

    What a scan carries under ``lax.cond`` stays on the host here, since
    the host knows it ahead: ``reset_ef`` zeroes the residuals before its
    round, ``eval_write`` copies the model into ``evals[eval_slot]`` after
    its round (an O(E x n) buffer, never the model every round), and
    ``overlap_round`` replays the overlap graph instead. Calling the
    program runs all rounds and returns ``{"flat", "residuals", "evals",
    "ys"}``, ``ys`` holding a [R, ...] tensor for each per-round output of
    the round (``loss``, the Fig. 4 ``overlap_counts`` [R, n], a traced
    plan's ``ys_extra``). Capture failure raises; nothing falls back to
    eager rounds on the card."""

    def __init__(self, sim: SimScan, flat, residuals, evals, xs):
        self.sim = sim
        dev = sim.device
        self.host = {k: np.asarray(xs[k]) for k in HOST_KEYS if k in xs}
        self.rounds = int(self.host["eval_write"].shape[0])
        self.xs = _map_tree(lambda v: torch.as_tensor(v, device=dev),
                            {k: v for k, v in xs.items()
                             if k not in HOST_KEYS})
        self.flat, self.residuals, self.evals = flat, residuals, evals
        self.counter = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.ys: Dict[str, torch.Tensor] = {}
        if sim.with_overlap:
            self.ys["overlap_counts"] = torch.zeros(
                (self.rounds, flat.shape[0]), dtype=torch.int32, device=dev)
        self.overlap = bool(sim.with_overlap and "overlap_round" in self.host
                            and self.host["overlap_round"].any())
        self.graphs: Dict[bool, CapturedRound] = {}
        if dev.type == "cuda":
            self._capture()

    def _step(self, flat, residuals, counter, overlap: bool) -> None:
        """One round on the given state: read row ``counter``, run the
        round, record its outputs in ``ys`` at that row, advance."""
        row = _map_tree(lambda v: v.index_select(0, counter)[0], self.xs)
        out = self.sim.round_fn(flat, residuals, row, overlap)
        for key, val in out.items():
            buf = self.ys.get(key)
            if buf is None:
                buf = self.ys[key] = torch.zeros(
                    (self.rounds,) + tuple(val.shape), dtype=val.dtype,
                    device=val.device)
            buf.index_copy_(0, counter, val.unsqueeze(0))
        counter.add_(1)

    def _capture(self) -> None:
        sim, dev = self.sim, self.flat.device
        variants = [False] + ([True] if self.overlap else [])

        def warm_up():
            # on scratch copies of the state, each variant WARMUP times
            flat_w = self.flat.clone()
            res_w = self.residuals.clone()
            counter_w = torch.zeros_like(self.counter)
            for overlap in variants:
                for _ in range(WARMUP):
                    counter_w.zero_()
                    self._step(flat_w, res_w, counter_w, overlap)
            for buf in self.ys.values():
                buf.zero_()

        pool = None
        for overlap in variants:
            self.graphs[overlap] = graph = CapturedRound(
                lambda o=overlap: self._step(self.flat, self.residuals,
                                             self.counter, o),
                warm_up if pool is None else None, dev, pool=pool,
                generator=sim.generator)
            pool = graph.graph.pool()
            CAPTURE_COUNTS[(sim.kind, sim.spec.strategy,
                            sim.with_overlap)] += 1

    def __call__(self):
        host = self.host
        self.counter.zero_()
        for i in range(self.rounds):
            if "reset_ef" in host and host["reset_ef"][i]:
                self.residuals.zero_()
            overlap = self.overlap and bool(host["overlap_round"][i])
            if self.graphs:
                self.graphs[overlap].replay()
            else:
                self._step(self.flat, self.residuals, self.counter, overlap)
            if host["eval_write"][i]:
                self.evals[int(host["eval_slot"][i])].copy_(self.flat)
        return {"flat": self.flat, "residuals": self.residuals,
                "evals": self.evals, "ys": self.ys}


def make_sim_scan(loss_fn: Callable, params_template, *, lr: float,
                  acfg, eta: float = 1.0, with_overlap: bool = False,
                  make_batches: Optional[Callable] = None,
                  plan_fn: Optional[Callable] = None,
                  population: Optional[int] = None, device="cuda",
                  generator: Optional[torch.Generator] = None) -> SimScan:
    """The ENTIRE multi-round FL simulation as one program (the reference's
    ``lax.scan`` lowering): the server's flat params and EF residuals are
    carried in place from round to round, and everything the host scheduler
    decides per round arrives as stacked ``[R, ...]`` plan rows ``xs``::

        sim(flat [n] f32,
            residuals [C, n] f32 ([0] when the strategy carries no EF),
            evals [E, n] f32 (zeros; E = number of eval rounds >= 1),
            xs: {
              "step_mask"  [R, C, S] bool,   # padded-step validity
              "active"     [R, C]    bool,   # padded cohort-slot validity
              "weights"    [R, C]    f32,    # 0 at inactive slots
              "ks"         [R, C]    int32,
              "eval_write" [R]       bool,   # snapshot the model this round
              "eval_slot"  [R]       int32,  # evals row it lands in
              "reset_ef"   [R]       bool,   # EF only: cohort resized
              + whatever ``make_batches`` consumes (default: "batches", a
                dict of [R, C, S, ...] stacked client batches; the
                simulation passes [R, C, S, B] sample indices and a gather
                from the training set held once on the device),
              + with_overlap: "ks_overlap" [R, C] int32, "overlap_round" [R]
            })
        -> {"flat": [n], "residuals", "evals": [E, n],
            "ys": {"loss" [R][, "overlap_counts" [R, n]]}}

    The round is ``make_round_body``, the fused round step's body (on the
    card ``threshold_find`` + ``fused_merge`` on the global route,
    ``overlap_combine`` on the block route). How the rounds run, and which
    events stay on the host, is ``ScanProgram``'s docstring.

    ``plan_fn`` (optional) maps each raw xs row to the plan the body reads
    — the hook through which ``simulation.run_fl_traced`` draws cohorts,
    survivals, arrivals and batches inside the round from ``generator``
    (registered with the captured graph, so each replay draws anew). A
    plan's "ys_extra" dict is recorded per round in ``ys``.

    ``population=P`` switches to PER-CLIENT residuals (the "pop_scan"
    engine): ``residuals`` is ``[P + 1, n]``, the xs gain ``"cohort" [R, C]
    int32`` (slot -> client id), and each round gathers the cohort's rows
    into the ``[C, n]`` slots, runs the unchanged body, and scatters the
    updated rows back. Row P is a sentinel: padded slots point at it and
    write back what they read (zeros), so duplicate sentinel writes are
    value-identical and the row stays zero. ``reset_ef`` does not apply.

    ``BUILD_COUNTS[(kind, strategy, with_overlap)]`` counts this call.
    """
    dev = torch.device(device)
    spec = spec_for(acfg, dev)
    body = make_round_body(loss_fn, params_template, lr=lr, spec=spec,
                           eta=eta, make_batches=make_batches)
    per_client = population is not None and spec.needs_residuals
    kind = "pop_scan" if population is not None else "sim_scan"

    def round_fn(flat, res, x, overlap):
        p = plan_fn(x) if plan_fn is not None else x
        return body(flat, res, p, overlap,
                    cohort=x["cohort"].to(torch.int64) if per_client
                    else None)

    BUILD_COUNTS[(kind, spec.strategy, with_overlap)] += 1
    return SimScan(round_fn, spec, with_overlap, kind, dev, generator)


# ------------------------------------------------------- per-leaf (models)
def make_model_local_trainer(loss_fn: Callable, lr: float,
                             skip_masked: bool = True):
    """``local_train(params, batches, step_mask) -> (deltas, losses)``: the
    reference's masked local SGD for a real model, one client at a time.

    params: nested dict of tensors shared by the cohort; batches: dict of
    [C, S, ...] tensors; step_mask: bool [C, S]. ``loss_fn(params, batch)
    -> (loss, metrics)`` takes ONE client's batch of one step. Each client
    trains a copy of the params, ``p <- p - lr * g`` in the param's dtype
    (``lr`` rounded to that dtype first, as the reference's weakly typed
    scalar is; bf16 at full width), and its delta ``params - final`` (in
    the param's dtype) is written into a preallocated ``[C, *leaf]`` buffer,
    so the cohort costs C deltas and one working copy. The reported loss
    is the pre-update loss of a client's last real step (0 for a client
    with none).

    Steps with ``step_mask`` False are exact no-ops. With ``skip_masked``
    the mask is read on the host once a call and such steps (and clients
    with none) are skipped. Without it nothing is read on the host, as a
    CUDA graph needs: every (client, step) runs and ``torch.where`` keeps
    the old params where the mask is False. A real step runs the same ops
    on the same inputs either way, and a client with no real step gives
    ``p - p = +0``, the skipping route's zeros, so the two routes agree
    bit for bit.

    One client at a time is the reference's wave-composition contract: a
    client's delta depends on its own params, batches and mask alone, so it
    is the delta the reference's vmap gives that client. Returns (deltas,
    nested like params, of [C, *leaf]; losses f32 [C])."""
    def local_train(params, batches, step_mask):
        step_mask = torch.as_tensor(step_mask)
        c, n_steps = step_mask.shape
        mask = (step_mask.cpu().numpy().astype(bool) if skip_masked
                else np.ones((c, n_steps), bool))
        items = tree_items(params)
        dev = items[0][1].device
        on_dev = (None if skip_masked
                  else step_mask.to(device=dev, dtype=torch.bool))
        steps = {dtype: torch.full((), lr, dtype=dtype, device=dev)
                 for dtype in {p.dtype for _, p in items}}
        deltas = [torch.empty((c,) + tuple(p.shape), dtype=p.dtype,
                              device=p.device) for _, p in items]
        losses = torch.zeros((c,), dtype=torch.float32, device=dev)
        for ci in range(c):
            if not mask[ci].any():
                for d in deltas:
                    d[ci].zero_()
                continue
            cur = [p.detach().clone() for _, p in items]
            for s in range(n_steps):
                if not mask[ci, s]:
                    continue
                live = [t.requires_grad_(True) for t in cur]
                loss, _ = loss_fn(
                    tree_from_items(zip([k for k, _ in items], live)),
                    {k: b[ci, s] for k, b in batches.items()})
                grads = torch.autograd.grad(loss, live, allow_unused=True)
                with torch.no_grad():
                    loss = loss.detach().to(torch.float32)
                    if skip_masked:
                        for t, g in zip(cur, grads):
                            if g is not None:      # an unused leaf: g = 0
                                t.sub_(steps[t.dtype] * g.to(t.dtype))
                        losses[ci] = loss
                    else:
                        m = on_dev[ci, s]
                        for j, (t, g) in enumerate(zip(cur, grads)):
                            if g is not None:
                                t = t.detach()
                                cur[j] = torch.where(
                                    m, t - steps[t.dtype] * g.to(t.dtype), t)
                        losses[ci] = torch.where(m, loss, losses[ci])
            with torch.no_grad():
                for (_, p), t, d in zip(items, cur, deltas):
                    torch.sub(p, t, out=d[ci])
            del cur
        return (tree_from_items(zip([k for k, _ in items], deltas)),
                losses)

    return local_train


def _merge_leaf_kernels(updates, w, ks, *, gamma, overlap_d, opwa,
                        residuals, active, kernel_codec):
    """The kernel route of ``compress_merge_leaf``: the leaf viewed as
    ``[C, leaf_n]`` f32 through ``kops.megakernel_aggregate``
    (``threshold_find`` then ``fused_merge``; the twins on CPU tensors)."""
    from repro_torch.kernels import ops as kops
    c, shape = updates.shape[0], tuple(updates.shape[1:])
    u2 = updates.to(torch.float32).reshape(c, -1)
    r2 = (residuals.to(torch.float32).reshape(c, -1)
          if residuals is not None else None)
    agg2, new_res2 = kops.megakernel_aggregate(
        u2, ks, w, residuals=r2, active=active, opwa=opwa,
        gamma=float(gamma), d=int(overlap_d), codec=kernel_codec or "none")
    return (agg2.reshape(shape),
            new_res2.reshape((c,) + shape) if residuals is not None
            else None)


def compress_merge_leaf(updates: torch.Tensor, coeffs: torch.Tensor,
                        ks: torch.Tensor, *, gamma: float = 1.0,
                        overlap_d: int = 1, opwa: bool = True,
                        use_kernel="auto",
                        residuals: Optional[torch.Tensor] = None,
                        active: Optional[torch.Tensor] = None,
                        value_codec: Optional[Callable] = None,
                        kernel_codec: Optional[str] = None
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Compress + merge ONE leaf of C clients' updates ``[C, *shape]``.

    Selection is per client over the whole leaf (every non-client axis, as
    the reference's rank-agnostic bisection), at traced counts ``ks`` [C];
    ``coeffs`` [C] weigh the merge. ``residuals`` ([C, *shape] f32)
    switches on error feedback. ``opwa=False`` is the plain weighted merge
    of the compressed values. ``active`` (bool [C]) gates padded cohort
    slots out of the merge and the overlap counts; their residuals pass
    through. ``value_codec`` (a registry ``Strategy.value_codec``) is
    applied to the survivors before the merge and the residual update;
    ``kernel_codec`` is its kernel stage.

    ``use_kernel`` ("auto": the kernels for CUDA tensors, the plain path for
    CPU tensors; True; False): the kernel route views the leaf as
    ``[C, leaf_n]`` f32 and runs ``threshold_find`` + ``fused_merge``
    (bit-exact with the plain route: same selection, same EF and codec
    arithmetic; the merge sums clients in another order). The plain route
    is the reference's: ``topk_compress_dynamic`` per client, the codec,
    EF, then ``opwa_aggregate`` or the weighted sum.

    Returns (agg [*shape] f32, new_residuals | None)."""
    w = coeffs.to(device=updates.device, dtype=torch.float32)
    if active is not None:
        w = torch.where(active, w, torch.zeros_like(w))
    ks = torch.as_tensor(ks, device=updates.device)
    if ((value_codec is None or kernel_codec is not None)
            and comp.resolve_use_kernel(use_kernel, updates.device)):
        return _merge_leaf_kernels(
            updates, w, ks, gamma=gamma, overlap_d=overlap_d, opwa=opwa,
            residuals=residuals, active=active, kernel_codec=kernel_codec)
    c, shape = updates.shape[0], tuple(updates.shape[1:])
    x = updates.to(torch.float32)
    if residuals is not None:
        x = residuals + x
    vals, mask = comp.topk_compress_dynamic(x.reshape(c, -1), ks)
    vals, mask = vals.reshape(x.shape), mask.reshape(x.shape)
    if value_codec is not None:
        vals = value_codec(vals, mask)
    new_res = (x - vals) if residuals is not None else None
    del x       # a full-width leaf's [C, n] f32 copies are GBs each
    if active is not None:
        # padded rows are all-zero updates whose tie-at-zero Top-K mask is
        # all-True: gate them out of the merge and the counts; their
        # residuals pass through unchanged (vals and mask are this
        # function's own tensors, gated in place)
        ax = active.reshape((-1,) + (1,) * len(shape))
        vals.mul_(ax)
        mask.logical_and_(ax)
        if new_res is not None:
            new_res = torch.where(ax, new_res, residuals.to(torch.float32))
    if opwa:
        agg = opwa_mod.opwa_aggregate(vals, mask, w, gamma, overlap_d,
                                      use_kernel=False)
    else:
        agg = opwa_mod.weighted_sum(w, vals)
    return agg, new_res


def init_mesh_residuals(params_template, cohort: int):
    """Per-leaf EF residuals for the real-model round: one f32
    ``[cohort, *leaf]`` zero buffer per parameter leaf, nested like the
    params (the per-leaf twin of the simulation's ``[C, n]`` matrix)."""
    return tree_from_items(
        (path, torch.zeros((cohort,) + tuple(p.shape), dtype=torch.float32,
                           device=p.device))
        for path, p in tree_items(params_template))


# ---------------------------------------------------------- the mesh scan
#: ("mesh_scan", strategy) -> mesh-scan programs prepared for a run's
#: buffers by ``MeshSimScan.compile``: one a run, however many chunks it
#: replays (on the card each is one CUDA graph capture)
TRACE_COUNTS: collections.Counter = collections.Counter()


class MeshSimScan:
    """The multi-round real-model program of ``make_mesh_sim_scan``.
    ``compile(params, residuals, xs)`` binds it to those buffers and a
    chunk of plan rows and returns a ``MeshScanProgram``; ``sim(params,
    residuals, xs)`` compiles and runs the chunk."""

    def __init__(self, body: Callable, strategy: str, ef: bool):
        self.body = body
        self.strategy = strategy
        self.ef = ef

    def compile(self, params, residuals, xs) -> "MeshScanProgram":
        return MeshScanProgram(self, params, residuals, xs)

    def __call__(self, params, residuals, xs):
        return self.compile(params, residuals, xs)()


class MeshScanProgram:
    """Rounds of the real-model trajectory, bound to the run's ``params``
    and per-leaf EF ``residuals``, which every round updates in place.

    The plan rows (``xs``, numpy or tensors, [T, ...]) live on the device
    in static buffers of the first chunk's length; ``load(xs)`` copies a
    later chunk (no longer) into them. A device counter picks each round's
    row inside the round, and each round's loss lands in a device ``[T]``
    buffer, so a round takes no host-to-device copy and no host read.

    On the card the round is captured once into a ``CUDAGraph`` and every
    later round, in this chunk and the next ones, is one replay. The
    capture comes after the first round has run for real, eagerly, on the
    capture's stream: that round loads the kernels, cuBLAS and the autograd
    engine and fills the allocator, none of which a capture may do, and it
    needs no copy of the state (a full-width model's EF residuals would not
    fit twice). The eager round's cached blocks are released before the
    capture, so they and the graph's private pool are not held together.
    The graph runs the same kernels on the same inputs as an eager round,
    so its replays give the eager round's bits. ``threshold_find.reads_log``
    is off during the eager round and the capture, and the kernels'
    launches recorded by the capture are added to their counters at each
    replay. Capture failure raises; nothing falls back to eager rounds on
    the card. On the CPU every round runs eagerly, once a row.

    Calling the program runs the loaded rounds and returns ``{"params",
    "residuals", "ys": {"loss" [T]}}``; ``capture_s`` is the time the call
    spent capturing (0 once captured), ``eager_s`` the wall of the eager
    round (None on the CPU), ``launches_per_replay`` the kernel launches
    one replay makes."""

    def __init__(self, sim: MeshSimScan, params, residuals, xs):
        self.sim = sim
        self.params, self.residuals = params, residuals
        self.device = tree_items(params)[0][1].device
        dev = self.device
        self.xs = _map_tree(
            lambda v: torch.as_tensor(v, device=dev).clone(), xs)
        self.capacity = self.rounds = int(self.xs["active"].shape[0])
        self.counter = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.loss = torch.zeros((self.capacity,), dtype=torch.float32,
                                device=dev)
        self.graph: Optional[CapturedRound] = None
        self.launches_per_replay: Dict = {}
        self.capture_s = 0.0
        self.eager_s: Optional[float] = None
        TRACE_COUNTS[("mesh_scan", sim.strategy)] += 1

    def load(self, xs) -> None:
        """Copy a chunk's plan rows ([T', ...], T' <= the first chunk's T)
        into the static buffers."""
        flat_new = tree_items(xs)
        flat_old = dict(tree_items(self.xs))
        t = int(np.asarray(xs["active"]).shape[0])
        if t > self.capacity:
            raise ValueError(f"chunk of {t} rounds exceeds the program's "
                             f"{self.capacity}")
        for path, v in flat_new:
            buf = flat_old[path]
            v = torch.as_tensor(v)
            if tuple(v.shape[1:]) != tuple(buf.shape[1:]):
                raise ValueError(f"xs{list(path)}: rows of shape "
                                 f"{tuple(v.shape[1:])}, program holds "
                                 f"{tuple(buf.shape[1:])}")
            buf[:t].copy_(v)
        self.rounds = t

    def _step(self) -> None:
        """One round: read row ``counter``, run the body on the bound
        state, record its loss at that row, advance."""
        row = _map_tree(lambda v: v.index_select(0, self.counter)[0],
                        self.xs)
        _, _, loss = self.sim.body(
            self.params, self.residuals if self.sim.ef else None,
            row["batches"], row["step_mask"], row["weights"], row["crs"],
            row["active"])
        self.loss.index_copy_(0, self.counter,
                              loss.to(torch.float32).reshape(1))
        self.counter.add_(1)

    def _eager_round_and_capture(self) -> None:
        self.graph = CapturedRound(self._step, self._step, self.device)
        self.eager_s = self.graph.warm_up_s
        self.capture_s = self.graph.capture_s
        self.launches_per_replay = self.graph.launches

    def __call__(self):
        self.counter.zero_()
        self.capture_s = 0.0
        for i in range(self.rounds):
            if self.device.type != "cuda":
                self._step()
            elif self.graph is None:
                self._eager_round_and_capture()
            else:
                self.graph.replay()
        return {"params": self.params, "residuals": self.residuals,
                "ys": {"loss": self.loss[:self.rounds]}}


def make_mesh_sim_scan(loss_fn: Callable, params_template, *, lr: float,
                       strategy: str = "bcrs_opwa", eta: float = 1.0,
                       gamma: float = 5.0, overlap_d: int = 1,
                       use_kernel="auto") -> MeshSimScan:
    """The real-model FL trajectory as one program (the reference's
    ``lax.scan`` of ``mesh_round.make_round_body``): the params (nested
    dict, any leaf dtypes) and the per-leaf EF residuals (``[C, *leaf]``
    f32, eftopk; a ``[0]`` placeholder without EF) are carried in place
    from round to round::

        sim(params, residuals,
            xs: {"batches"   dict of [T, C, S, ...] stacked client batches,
                 "step_mask" [T, C, S] bool,   # padded-step validity
                 "active"    [T, C]    bool,   # padded cohort-slot validity
                 "weights"   [T, C]    f32,    # 0 at inactive slots
                 "crs"       [T, C]    f32})   # per-client BCRS ratios
        -> {"params", "residuals", "ys": {"loss" [T]}}

    ``T`` is a chunk of rounds: ``launch.fl_train`` compiles the program
    once a run (``TRACE_COUNTS[("mesh_scan", strategy)]``) and ``load``s
    each later chunk into it. How the rounds run is ``MeshScanProgram``'s
    docstring. The body trains every cohort slot's every local step and
    discards the masked ones (``make_model_local_trainer`` with
    ``skip_masked=False``), so a round reads nothing on the host; it gives
    the round engine's bits, which skips them. Per-leaf retained counts
    come from ``crs`` through ``k_for_ratio_traced``, as the host
    scheduler's."""
    from repro_torch.fed.mesh_round import make_round_body
    body = make_round_body(loss_fn, lr_local=lr, eta=eta, strategy=strategy,
                           gamma=gamma, overlap_d=overlap_d,
                           use_kernel=use_kernel, inplace=True,
                           skip_masked=False)
    return MeshSimScan(body, strategy,
                       strat_mod.get(strategy).needs_residuals)
