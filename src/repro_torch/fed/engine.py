"""Flat-space compression/aggregation substrate (torch port of the flat
half of ``repro.fed.engine``).

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
    reference's jnp path.

Everything strategy-shaped is read from the capability record; this module
never matches strategy names.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import compression as comp
from repro_torch.core import opwa as opwa_mod
from repro_torch.core import strategies as strat_mod


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
def make_unflatten(params_template: Dict[str, torch.Tensor]) -> Callable:
    """[n] flat f32 -> dict shaped like ``params_template``, in sorted-key
    order (the reference's ravel order). The leaves are views of ``flat``."""
    specs = [(k, tuple(params_template[k].shape),
              int(params_template[k].numel())) for k in sorted(params_template)]

    def unflatten(flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        out, off = {}, 0
        for key, shape, size in specs:
            out[key] = flat[off:off + size].view(shape)
            off += size
        return out

    return unflatten


def flatten_client_trees(deltas: Dict[str, torch.Tensor]) -> torch.Tensor:
    """dict of [C, ...] tensors -> [C, n] f32 in sorted-key (ravel) order."""
    return torch.cat([deltas[k].reshape(deltas[k].shape[0], -1)
                      .to(torch.float32) for k in sorted(deltas)], dim=1)


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

    params: dict of unbatched tensors; batches: dict of [C, S, ...];
    step_mask: bool [C, S]. Returns (delta dict of [C, ...] = params - final,
    losses [C]).
    """
    def local_train(params, batches, step_mask):
        c, n_steps = step_mask.shape
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
            delta = {k: params[k].unsqueeze(0) - cur[k] for k in cur}
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
