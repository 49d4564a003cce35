"""HBM traffic and operation counts of the port's kernels (torch port of
``repro.roofline.kernel_bytes``).

Two accountings of the client merge, as in the reference:

  * ``megakernel_hbm_bytes``: the traffic of the two-kernel pipeline
    (``csrc/threshold_find.cu`` then ``csrc/fused_merge.cu``) from its
    launch structure. ``threshold_find`` is one memset of its scratch and
    three passes: passes 1 and 2 read the whole row, pass 3 reads the
    compacted candidates of the chosen bin (at most n/8 a client, written
    by pass 2) or, for a client whose bin holds more than n/8 of its row,
    the whole row again: 2 or 3 reads of x a client, and of e alike under
    EF. ``threshold_find.reads_log`` reports which (``reads``). The global
    histograms' atomics stay in L2 and are not counted. ``fused_merge``
    reads the operands once, writes the ``[n]`` aggregate and, under EF,
    the new ``[C, n]`` residual. Nothing is padded: the kernels mask the
    ragged edge.
  * ``unfused_merge_bytes``: the plain route (``use_kernel=False``) of
    ``fed.engine.aggregate_updates`` counted op by op by
    ``op_cost.OpCounter`` on CPU zero tensors (every op a round trip to
    memory, as eager mode runs it on the card).

Below them, the least-traffic byte and operation counts of every kernel's
bound, which ``chip_smoke.py`` and ``round_times.py`` print as "Bound ms"
(``bound_ms``: the larger of the bytes over ``HBM_BW`` and the operations
over the peak rate of their type): each input read once and each output
written once, and the operations the function needs.

Each accounting is per logical call on one device.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core import strategies as strat_mod
from repro_torch.roofline.analysis import HBM_BW, PEAK_FLOPS_F32

_F32 = 4
_I32 = 4

#: threshold_find's digit bins (pass 1 and 2: 11 bits; pass 3: 9 bits) and
#: the ints of its scratch a client beyond the histograms
#: (``threshold_find.cu``'s ``Layout``)
_TF_BINS = (2048, 2048, 512)
_TF_SCRATCH_EXTRA = 13


def threshold_find_scratch_bytes(c: int) -> int:
    """Bytes of the scratch ``threshold_find`` zeroes with one memset: the
    three histograms, tickets, absmax, cursors and hand-overs."""
    return (sum(_TF_BINS) + _TF_SCRATCH_EXTRA) * c * _I32


def candidate_cap(n: int) -> int:
    """Candidates pass 2 may compact for one client: n / 8, at least 1."""
    return max(n // 8, 1)


def megakernel_hbm_bytes(c: int, n: int, strategy: str,
                         reads: Optional[Sequence[int]] = None) -> dict:
    """Bytes the two-kernel pipeline moves for one [C, n] merge.

    ``reads``: the reads of x each client took (2 or 3, as
    ``threshold_find.reads_log`` gives them); 2 for every client when
    omitted. A client read twice also writes and reads back its compacted
    candidates, counted here at their cap (n / 8).

    Returns ``{"threshold", "merge", "total", "passes"}``, ``passes`` =
    total / (C*n*4): logical full reads of the update matrix.

    The strategy's registered capabilities drive the accounting: the EF
    residual stream follows ``needs_residuals``, the codec scale column
    (threshold_find's [C] absmax written, fused_merge's read) follows
    ``kernel_codec``, and a strategy that declares ``megakernel=False`` is
    refused: its traffic is not this pipeline's."""
    strat = strat_mod.get(strategy)
    if not strat.megakernel:
        raise ValueError(
            f"strategy {strategy!r} does not route through the megakernel "
            f"pipeline (megakernel=False); its traffic is not modeled here")
    ef = strat.needs_residuals
    codec = strat.kernel_codec is not None
    reads = [2] * c if reads is None else [int(r) for r in reads]
    if len(reads) != c or any(r not in (2, 3) for r in reads):
        raise ValueError(f"reads: one 2 or 3 a client, got {reads}")
    n_ops = 2 if ef else 1           # x (and e) streamed
    row = n * _F32
    thresh = threshold_find_scratch_bytes(c) + c * (_I32 + _I32)   # ks, th
    for r in reads:
        thresh += r * n_ops * row
        if r == 2:
            thresh += 2 * candidate_cap(n) * _I32   # compacted, read back
    if codec:
        thresh += c * _F32           # [C] absmax (the quantizer scale)
    mat = c * row
    # fused merge: one read of the operands, the [C] thresholds and
    # weights, the [n] aggregate written (and the new residual)
    merge = n_ops * mat + n * _F32 + c * (_I32 + _F32)
    if codec:
        merge += c * _F32            # [C] scales read
    if ef:
        merge += mat                 # new residuals written
    total = thresh + merge
    return {"threshold": float(thresh), "merge": float(merge),
            "total": float(total), "passes": total / (c * n * _F32)}


def wire_stream_bytes(strategy: str, n: int, k: int) -> dict:
    """Bytes-on-the-wire pricing of one client's upload under the
    strategy's registered ``WireFormat``, against the idx32+f32 reference
    pair (8 B/survivor).

    ``pair_ratio`` is the PER-SURVIVOR value+index stream ratio — the
    number the packed formats are judged on (int8: (4+1)/8 = 5/8; int4:
    (4+0.5)/8 = 9/16); the per-message scale rides in ``overhead_bytes``
    and is amortized over k in ``total_ratio`` (a bitmask stream, priced
    per coordinate, lands there too).
    """
    wire = strat_mod.get(strategy).wire
    if wire.dense:
        raise ValueError(
            f"strategy {strategy!r} exchanges dense tensors; survivor-"
            "stream pricing is meaningless (see cost_model."
            "uncompressed_round)")
    ref_pair = 8.0                  # idx32 + f32
    pair = wire.index_bytes + wire.value_bytes
    total = wire.bytes_on_wire(n, k)
    return {"kind": wire.kind,
            "pair_bytes": pair,
            "pair_ratio": pair / ref_pair,
            "overhead_bytes": wire.overhead_bytes,
            "mask_bits": wire.mask_bits,
            "bytes_on_wire": float(total),
            "ref_bytes": ref_pair * k,
            "total_ratio": float(total) / (ref_pair * k)}


def unfused_merge_bytes(spec, c: int, n: int) -> dict:
    """HBM bytes of the plain route of ``aggregate_updates`` for a [C, n]
    merge, counted op by op on CPU zero tensors (``OpCounter``: operands
    plus results of every op but views). ``spec``: a
    ``fed.engine.ClientUpdateSpec`` with ``use_kernel=False``."""
    import torch
    from repro_torch.fed.engine import aggregate_updates
    from repro_torch.roofline.op_cost import OpCounter
    if spec.use_kernel:
        raise ValueError("the baseline is the plain route (use_kernel=False)")
    u = torch.zeros((c, n), dtype=torch.float32)
    w = torch.ones((c,), dtype=torch.float32) / c
    ks = torch.ones((c,), dtype=torch.int32)
    r = (torch.zeros((c, n), dtype=torch.float32)
         if strat_mod.get(spec.strategy).needs_residuals else None)
    counter = OpCounter()
    with torch.no_grad(), counter:
        aggregate_updates(spec, u, w, ks, residuals=r)
    return {"total": float(counter.bytes),
            "passes": counter.bytes / (c * n * _F32),
            "n_ops": counter.n_ops}


def merge_traffic_ratio(spec, c: int, n: int) -> dict:
    """unfused / kernel HBM-byte ratio for one [C, n] merge (>= 3x is the
    acceptance bar for the megakernel pipeline)."""
    kern = megakernel_hbm_bytes(c, n, spec.strategy)
    base = unfused_merge_bytes(spec, c, n)
    return {"c": c, "n": n, "strategy": spec.strategy,
            "kernel": kern, "unfused": base,
            "ratio": base["total"] / kern["total"]}


# ------------------------------------------------------- the kernels' bounds
def bound_ms(nbytes: float, ops: float, ops_per_s: float = PEAK_FLOPS_F32):
    """(ms, "bytes" or "operations"): the larger of ``nbytes`` over the HBM
    rate and ``ops`` over ``ops_per_s``, and which one it is."""
    bound_bytes = nbytes / HBM_BW * 1e3
    bound_ops = ops / ops_per_s * 1e3
    return (max(bound_bytes, bound_ops),
            "bytes" if bound_bytes >= bound_ops else "operations")


def threshold_find_bound(c: int, n: int, ef: bool = False):
    """(bytes, operations): x (and e) read once, ks read and thresholds
    written; at least one magnitude comparison an element."""
    return c * n * 4 * (1 + int(ef)) + c * 4 * 2, c * n


def fused_merge_bound(c: int, n: int, ef: bool = False):
    """(bytes, operations): x (and e) read once, the aggregate (and the
    new residual) written once, thresholds and weights read; [+e], a
    multiply, an add, [a subtract] and the gate an element."""
    return c * n * 4 * (1 + 2 * int(ef)) + n * 4 + c * 8, c * n * (3 + 2 * int(ef))


def block_topk_bound(nb: int, block: int):
    """(bytes, operations) on [nb, block] rows: x read once, values and the
    int8 mask written once (9 B); 4 digit passes of a shift and a compare,
    and the mask's compare (9 operations)."""
    return nb * block * 9, nb * block * 9


def ef_update_bound(nb: int, block: int):
    """(bytes, operations): g and e read once, send and residual written
    once (16 B); block_topk's 9 operations, the add and the subtract."""
    return nb * block * 16, nb * block * 11


def overlap_combine_bound(c: int, n: int):
    """(bytes, operations): values (4 B) and mask (1 B) read per
    client-element, the output (4 B) written per column, the coefficients
    once; a multiply, an add and a count per client-element, the enlarging
    multiply per column."""
    return c * n * 5 + n * 4 + c * 4, c * n * 3 + n


def causal_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs the mask keeps: positions aligned at the top left."""
    if not causal:
        return sq * sk
    m = min(sq, sk)
    return m * (m + 1) // 2 + max(0, sq - sk) * sk


def flash_bound(b: int, h: int, sq: int, sk: int, d: int, esize: int,
                causal: bool):
    """(bytes, operations) of one attention call on [b*h, s, d] heads: q,
    k, v read and o written once, counted as 4 tensors of ``sq`` rows of
    ``esize`` bytes (every timed shape has sq = sk), and two products of
    d multiply-adds for each kept (query, key) pair."""
    return 4 * b * h * sq * d * esize, 4 * b * h * causal_pairs(sq, sk, causal) * d


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(t) for t in tree.values())
    return tree.numel() * tree.element_size()


def decode_step_bytes(model, params, batch: int, positions: int,
                      cache_len: Optional[int] = None):
    """(total bytes, state bytes) a decode step must move at cache length
    ``positions``: every weight a step reads (all but the embedding table,
    of which B rows, and the encoder, ``vis_proj`` and the MTP head, which
    decode never reads; every expert of a MoE layer), the K and V cache up
    to the position (each layer's window at most) and the new K/V entries
    (MLA: its latent and rope key), the cross caches read whole (encdec's
    ``cache_len`` positions, vlm's patches), the recurrent state (hymba's
    conv history and SSM state, rwkv's token shifts and wkv state), read
    once and written once, and the logits."""
    cfg = model.cfg
    emb = params["embed"]["w"]
    unread = _nbytes(emb) + sum(_nbytes(params[k]) for k in ("encoder",
                                                            "vis_proj", "mtp")
                                if k in params)
    weights = _nbytes(params) - unread + batch * emb.shape[1] * \
        emb.element_size()
    kv = cross = 0
    if cfg.mla is not None:
        entry = batch * (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) * 2
        kv = entry * (positions + 1) * cfg.n_layers
    elif cfg.family != "ssm":
        entry = 2 * batch * cfg.n_kv_heads * cfg.resolved_head_dim * 2
        wins = model._window_flags() or [positions + 1] * cfg.n_layers
        kv = sum(entry * min(positions + 1, w) for w in wins)
        if cfg.family == "encdec":
            cross = entry * cache_len * cfg.n_layers
        elif cfg.family == "vlm":
            cross = entry * cfg.vision.n_patches * cfg.vision.n_cross_layers
    one = model.init_cache(batch, 1)
    state = _nbytes(one) - sum(_nbytes(one[k]) for k in ("k", "v", "ck", "cv",
                                                         "mla") if k in one)
    del one
    total = weights + kv + cross + 2 * state + batch * model.v_pad * 2
    return total, state
