"""Smoke run of the PyTorch/CUDA port on one Hopper card.

    python3 chip_smoke.py [--out PATH] [--profile]

1. builds the five hand-written kernels (``src/repro_torch/csrc``; one nvcc
   per source, started together);
2. holds ``threshold_find`` and ``fused_merge`` bit for bit against their
   plain PyTorch twins, for every variant, at the main path's shape (C=5,
   n=136,724), the README's priced point (C=32, n=65,536), a real-model leaf
   (C=8, n=2048*5632, the stablelm-1.6b MLP matrix) and a ragged edge (C=3,
   n=1001), and ``block_topk``, ``ef_update`` and ``overlap_combine`` at the
   main shape, the leaf and a ragged shape (block 1000; C=3, n=1001) with
   edge rows (zeros, ties, huge, NaN, inf, a 1e-15-under-1.0 row, denormals);
   times kernel, twin and the nearest single PyTorch call with CUDA events;
3. drives each path with the kernels' launch counters reset just before and
   read just after: the fused engine ``run_fl(engine="fused")`` at the
   simulation MLP's full width for 5 rounds under bcrs_opwa, eftopk, qtopk
   and int4; the legacy engine ``run_fl(engine="legacy", block_topk=True)``
   for 5 rounds under bcrs_opwa, bcrs, eftopk and qtopk; the fused engine
   with ``block_topk=True`` (bcrs_opwa, 5 rounds); and the EF entry point
   ``ops.ef_topk_update`` over 5 steps of a 5-client cohort;
4. holds ``aggregate_updates`` on the card (kernel route) against the plain
   path on the CPU for all 8 built-in strategies, and one legacy round's
   ``aggregate`` (block_topk + overlap_combine) against the exact plain
   route on the same MLP deltas;
5. with ``--profile``, profiles 3 rounds of the fused and of the legacy
   path (device time by kernel, idle share).

Any failed check exits nonzero. The last two lines are the ``kernels`` JSON
and ``{"ok": true, "device": ...}``. Needs CUDA and the repository's
``src/``; ``--out`` also writes the full record as JSON.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
MAIN = (5, 136_724)           # cohort x simulation-MLP parameters
PRICED = (32, 65_536)
LEAF = (8, 2048 * 5632)       # stablelm-1.6b MLP matrix as one [C, n] leaf
RAGGED = (3, 1001)
STRATEGIES = ("bcrs_opwa", "eftopk", "qtopk", "int4")
LEGACY_STRATEGIES = ("bcrs_opwa", "bcrs", "eftopk", "qtopk")
ROUNDS = 5
BLOCK = 8192                  # AggregationConfig.block_size default
CR = 0.1                      # AggregationConfig.cr default
#: [nb, block] rows of the block kernels: the main path's one client
#: (n = 136,724 zero-padded to 17 blocks), the leaf (2048*5632 / 8192 rows)
#: and a ragged flat n = 1001 at block 1000
BLOCK_MAIN = (-(-MAIN[1] // BLOCK), BLOCK)
BLOCK_LEAF = (LEAF[1] // BLOCK, BLOCK)
BLOCK_RAGGED = (2, 1000)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    d = (a.double() - b.double()).abs()
    d = torch.nan_to_num(d, nan=0.0)     # equal-bit NaNs were checked above
    return float(d.max()) if d.numel() else 0.0


def time_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after two warm-ups."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def make_case(c: int, n: int, seed: int):
    """Updates with the edges the kernels must keep exact: an all-zero row,
    a block of ties, a denormal row, a huge row; k from 1 to n."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(c, n, device="cuda", generator=g)
    e = 0.3 * torch.randn(c, n, device="cuda", generator=g)
    x[0] = 0.0
    e[0] = 0.0
    if c > 1:
        x[1, : n // 2] = x[1, 0]
    if c > 2:
        x[2] *= 1e-40
    if c > 3:
        x[3] *= 1e30
    ks = torch.randint(1, n + 1, (c,), device="cuda", generator=g,
                       dtype=torch.int32)
    ks[-1] = 1
    if c > 1:
        ks[1] = n
    w = torch.rand(c, device="cuda", generator=g) + 0.1
    w = (w / w.sum()).contiguous()
    active = torch.ones(c, device="cuda")
    active[-1] = 0.0
    return x, e, ks, w, active


# ------------------------------------------------- kernels against twins
def kernel_parity(tf, fm, shapes, record):
    """Every variant of both kernels against their twins, bitwise."""
    from repro_torch.core.strategies import CODEC_LEVELS, quantization_scale
    worst = {"threshold_find": 0.0, "fused_merge": 0.0}
    cases = 0
    for seed, (c, n) in enumerate(shapes):
        x, e, ks, w, active = make_case(c, n, seed)
        for ef in (False, True):
            ee = e if ef else None
            th, am = tf.threshold_find(x, ks, ee, emit_scale=True)
            th2 = tf.threshold_find(x, ks, ee)
            tp, ap = tf.threshold_find_plain(x, ks, ee, emit_scale=True)
            torch.cuda.synchronize()
            check(torch.equal(th, tp) and torch.equal(th2, tp),
                  f"threshold_find thresholds C={c} n={n} ef={ef}")
            check(bits_equal(am, ap), f"threshold_find absmax C={c} n={n}")
            worst["threshold_find"] = max(worst["threshold_find"],
                                          max_abs(th.double(), tp.double()))
            cases += 1
            codecs = ("none", "int8", "int4") if ef else ("none",)
            for opwa in (False, True):
                for act in (None, active):
                    for codec in codecs:
                        sc = (quantization_scale(am, CODEC_LEVELS[codec])
                              if codec != "none" else None)
                        kw = dict(opwa=opwa, gamma=5.0, d=1, codec=codec,
                                  scales=sc)
                        got = fm.fused_merge(x, th, w, ee, act, **kw)
                        want = fm.fused_merge_plain(x, th, w, ee, act, **kw)
                        torch.cuda.synchronize()
                        got = got if ef else (got,)
                        want = want if ef else (want,)
                        for g_, w_ in zip(got, want):
                            check(bits_equal(g_, w_),
                                  f"fused_merge C={c} n={n} ef={ef} "
                                  f"opwa={opwa} active={act is not None} "
                                  f"codec={codec}")
                            worst["fused_merge"] = max(worst["fused_merge"],
                                                       max_abs(g_, w_))
                        cases += 1
        del x, e
        torch.cuda.empty_cache()
    record["parity_cases"] = cases
    return worst


def kernel_timings(tf, fm, record):
    """Kernel, twin and library-call times at the main path's shape and at
    the leaf shape, beside the bound from bytes (and f32 operations)."""
    rows = []
    for label, (c, n), reps in (("main", MAIN, 50), ("leaf", LEAF, 10)):
        g = torch.Generator(device="cuda").manual_seed(7)
        x = torch.randn(c, n, device="cuda", generator=g)
        e = 0.3 * torch.randn(c, n, device="cuda", generator=g)
        ks = torch.full((c,), max(1, round(0.1 * n)), dtype=torch.int32,
                        device="cuda")
        w = torch.full((c,), 1.0 / c, device="cuda")
        th = tf.threshold_find(x, ks)
        th_ef = tf.threshold_find(x, ks, e)
        bits = x.abs().view(torch.int32)
        elems = c * n
        # threshold_find as the main path calls it (no EF: bcrs_opwa):
        # x read once, ks read and thresholds written; at least one
        # magnitude comparison per element
        tf_bytes = elems * 4 + c * 4 * 2
        tf_ops = elems
        rows.append(dict(
            kernel="threshold_find", shape=label, C=c, n=n, variant="x only",
            bytes=tf_bytes, ops=tf_ops,
            bound_by=("bytes" if tf_bytes / HBM_BYTES_PER_S
                      >= tf_ops / F32_OPS_PER_S else "operations"),
            bound_ms=max(tf_bytes / HBM_BYTES_PER_S,
                         tf_ops / F32_OPS_PER_S) * 1e3,
            ms=time_ms(lambda: tf.threshold_find(x, ks), reps),
            plain_ms=time_ms(lambda: tf.threshold_find_plain(x, ks),
                             max(3, reps // 5)),
            library="torch.sort of the row bit patterns",
            library_ms=time_ms(lambda: torch.sort(bits, dim=1), reps)))
        for variant, ee, opwa, thr in (("opwa (bcrs_opwa)", None, True, th),
                                       ("ef (eftopk)", e, False, th_ef)):
            ef = ee is not None
            # x (+ e) read once, agg (+ residual') written once, th and w
            fm_bytes = elems * 4 * (1 + 2 * int(ef)) + n * 4 + c * 8
            fm_ops = elems * (3 + 2 * int(ef))   # [+e], mul, add, [-], gate
            bound_bytes = fm_bytes / HBM_BYTES_PER_S * 1e3
            bound_ops = fm_ops / F32_OPS_PER_S * 1e3
            rows.append(dict(
                kernel="fused_merge", shape=label, C=c, n=n, variant=variant,
                bytes=fm_bytes, ops=fm_ops,
                bound_by="bytes" if bound_bytes >= bound_ops else "operations",
                bound_ms=max(bound_bytes, bound_ops),
                ms=time_ms(lambda: fm.fused_merge(
                    x, thr, w, ee, opwa=opwa, gamma=5.0), reps),
                plain_ms=time_ms(lambda: fm.fused_merge_plain(
                    x, thr, w, ee, opwa=opwa, gamma=5.0), max(3, reps // 5)),
                library="none (no single PyTorch call computes it)",
                library_ms=None))
        del x, e, bits
        torch.cuda.empty_cache()
    record["timings"] = rows
    return rows


# ---------------------------------- block route kernels against twins
def block_rows(nb: int, block: int, seed: int) -> torch.Tensor:
    """[nb, block] f32 rows on the card; with eight rows or more the first
    eight are the block kernels' edge rows (zeros, ties, huge, NaN, inf, a
    k-th magnitude below rowmax*2^-40, all denormal, denormal mids), else
    one NaN and a mixed normal / denormal row."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(nb, block, device="cuda", generator=g)
    if nb >= 8:
        x[0] = 0.0
        x[1, : block // 2] = x[1, 0]
        x[2] *= 1e30
        x[3, 5] = float("nan")
        x[4, 7] = float("inf")
        x[5] = 0.0
        x[5, 0], x[5, 1:21] = 1.0, 1e-15
        x[6] *= 1e-40
        x[7] = 0.0
        x[7, :20] = 2e-38
    else:
        x[0, 3] = float("nan")
        x[-1, : block // 3] *= 1e-40
    return x


def combine_case(c: int, n: int, seed: int):
    """Dense-masked values [C, n], int8 masks of mixed density, coeffs."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    density = 0.05 + 0.5 * torch.rand(c, 1, device="cuda", generator=g)
    masks = torch.rand(c, n, device="cuda", generator=g) < density
    vals = torch.randn(c, n, device="cuda", generator=g) * masks
    coeffs = 0.05 + torch.rand(c, device="cuda", generator=g)
    return vals, masks.to(torch.int8), coeffs


def block_parity(mods, record):
    """block_topk and ef_update at the main, leaf and ragged rows (k = 1,
    the default ratio's k, k = block), overlap_combine at the main, leaf
    and ragged [C, n] (gamma 5 / d 1 and gamma 1 / d 2): bitwise."""
    from repro_torch.core.compression import k_for_ratio
    bt, eu, oc = mods["block_topk"], mods["ef_update"], mods["overlap_combine"]
    worst = {"block_topk": 0.0, "ef_update": 0.0, "overlap_combine": 0.0}
    cases = 0
    for seed, (nb, block) in enumerate((BLOCK_MAIN, BLOCK_LEAF,
                                        BLOCK_RAGGED)):
        x = block_rows(nb, block, 100 + seed)
        g = torch.Generator(device="cuda").manual_seed(200 + seed)
        e = 0.3 * torch.randn(nb, block, device="cuda", generator=g)
        e[0] = -x[0]                       # exact cancellation
        e[-1, :20] = 1e-40                 # denormal residuals
        for k in sorted({1, k_for_ratio(block, CR), block}):
            got, want = bt.block_topk(x, k), bt.block_topk_plain(x, k)
            torch.cuda.synchronize()
            check(bits_equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                  f"block_topk [{nb}, {block}] k={k}")
            worst["block_topk"] = max(worst["block_topk"],
                                      max_abs(got[0], want[0]))
            got, want = eu.ef_update(x, e, k), eu.ef_update_plain(x, e, k)
            torch.cuda.synchronize()
            for g_, w_ in zip(got, want):
                check(bits_equal(g_, w_), f"ef_update [{nb}, {block}] k={k}")
                worst["ef_update"] = max(worst["ef_update"], max_abs(g_, w_))
            cases += 2
        del x, e
    for seed, (c, n) in enumerate((MAIN, LEAF, RAGGED)):
        vals, masks, coeffs = combine_case(c, n, 300 + seed)
        for gamma, d in ((5.0, 1), (1.0, 2)):
            got = oc.overlap_combine(vals, masks, coeffs, gamma, d)
            want = oc.overlap_combine_plain(vals, masks, coeffs, gamma, d)
            torch.cuda.synchronize()
            check(bits_equal(got, want),
                  f"overlap_combine C={c} n={n} gamma={gamma} d={d}")
            worst["overlap_combine"] = max(worst["overlap_combine"],
                                           max_abs(got, want))
            cases += 1
        del vals, masks
    torch.cuda.empty_cache()
    record["block_parity_cases"] = cases
    return worst


def timing_row(kernel, shape, variant, nbytes, ops, ms, plain_ms, library,
               library_ms):
    """One timing record with its bound: the larger of bytes over the HBM
    rate and f32 operations over the f32 rate."""
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = ops / F32_OPS_PER_S * 1e3
    return dict(kernel=kernel, shape=shape, variant=variant, bytes=nbytes,
                ops=ops,
                bound_by="bytes" if bound_bytes >= bound_ops else "operations",
                bound_ms=max(bound_bytes, bound_ops), ms=ms,
                plain_ms=plain_ms, library=library, library_ms=library_ms)


def block_timings(mods, record):
    """block_topk, ef_update and overlap_combine at the main path's shape
    and at the leaf: kernel, twin and library call with CUDA events."""
    from repro_torch.core.compression import k_for_ratio
    from repro_torch.kernels.block_topk import N_ITERS
    bt, eu, oc = mods["block_topk"], mods["ef_update"], mods["overlap_combine"]
    rows = []
    for label, (nb, block), (c, n), reps in (
            ("main", BLOCK_MAIN, MAIN, 50), ("leaf", BLOCK_LEAF, LEAF, 10)):
        g = torch.Generator(device="cuda").manual_seed(8)
        x = torch.randn(nb, block, device="cuda", generator=g)
        e = 0.3 * torch.randn(nb, block, device="cuda", generator=g)
        mag = x.abs()
        k = k_for_ratio(block, CR)
        elems = nb * block
        variant = f"[{nb}, {block}] k={k}"
        topk = "torch.topk(|x|, k, dim=1)"
        few = max(3, reps // 5)
        # x read once, vals + int8 mask written once; the row max and 40
        # counting steps compare each element 41 times
        rows.append(timing_row(
            "block_topk", label, variant, elems * 9, elems * (N_ITERS + 1),
            time_ms(lambda: bt.block_topk(x, k), reps),
            time_ms(lambda: bt.block_topk_plain(x, k), few), topk,
            time_ms(lambda: torch.topk(mag, k, dim=1), reps)))
        # g, e read once, send, residual' written once; add, 41 compares,
        # subtract
        rows.append(timing_row(
            "ef_update", label, variant, elems * 16, elems * (N_ITERS + 3),
            time_ms(lambda: eu.ef_update(x, e, k), reps),
            time_ms(lambda: eu.ef_update_plain(x, e, k), few), topk,
            time_ms(lambda: torch.topk(mag, k, dim=1), reps)))
        del x, e, mag
        vals, masks, coeffs = combine_case(c, n, 9)
        # vals (4 B) + mask (1 B) read per client-element, out (4 B) written
        # per column, coeffs once; multiply, add and count per
        # client-element, the enlarge multiply per column
        rows.append(timing_row(
            "overlap_combine", label, f"C={c} n={n}",
            c * n * 5 + n * 4 + c * 4, c * n * 3 + n,
            time_ms(lambda: oc.overlap_combine(vals, masks, coeffs, 5.0, 1),
                    reps),
            time_ms(lambda: oc.overlap_combine_plain(vals, masks, coeffs,
                                                     5.0, 1), few),
            "none exists", None))
        del vals, masks
        torch.cuda.empty_cache()
    record["block_timings"] = rows
    return rows


# ------------------------------------------------------------ the paths
def drive(kern, fn):
    """Run ``fn`` with every kernel's launch counter set to 0 just before;
    returns (fn's result, the counts read just after)."""
    for wrapper in kern.values():
        wrapper.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: w.launches for name, w in kern.items()}


def check_counts(counts, want, what):
    check(counts == want, f"{what}: launches {counts}, expected {want}")


def run_paths(kern, record):
    """Every path this port runs on the card, each driven with the counts
    reset just before and read just after. Returns the launches summed over
    the paths, per kernel."""
    from repro_torch.core.aggregation import AggregationConfig
    from repro_torch.fed.simulation import FLSimConfig, cohort_slots, run_fl
    zero = {name: 0 for name in kern}
    total = dict(zero)
    paths = {}

    def one_run(label, acfg, engine, want):
        res, counts = drive(kern, lambda: run_fl(
            FLSimConfig(rounds=ROUNDS), acfg, engine=engine, device="cuda"))
        accs = [a for _, a in res.accuracies]
        check(len(res.executed_rounds) == ROUNDS, f"{label}: rounds executed")
        check(all(math.isfinite(v) for v in res.losses + accs),
              f"{label}: finite losses and accuracies")
        check_counts(counts, dict(zero, **want), label)
        for name, n in counts.items():
            total[name] += n
        paths[label] = dict(accuracies=res.accuracies, losses=res.losses,
                            wall_per_round_s=res.wall_per_round,
                            launches=counts)
        print(f"[path] {label}: wall per round (s) "
              f"{[round(t, 6) for t in res.wall_per_round]} "
              f"accuracies {res.accuracies} launches "
              f"{ {k: v for k, v in counts.items() if v} }")

    # the fused engine, global Top-K: threshold_find + fused_merge a round
    for s in STRATEGIES:
        one_run(f"fused {s}", AggregationConfig(strategy=s), "fused",
                {"threshold_find": ROUNDS, "fused_merge": ROUNDS})
    # the legacy engine, block Top-K: block_topk once per selected client,
    # overlap_combine once a round for the OPWA strategy
    cohort = cohort_slots(FLSimConfig().n_clients,
                          FLSimConfig().participation)
    for s in LEGACY_STRATEGIES:
        acfg = AggregationConfig(strategy=s, block_topk=True)
        one_run(f"legacy block {s}", acfg, "legacy",
                {"block_topk": ROUNDS * cohort,
                 "overlap_combine": ROUNDS if acfg.strat.overlap_weighted
                 else 0})
    # the fused engine, block Top-K: traced-k block compression in PyTorch,
    # the OPWA merge through overlap_combine
    one_run("fused block bcrs_opwa",
            AggregationConfig(strategy="bcrs_opwa", block_topk=True),
            "fused", {"overlap_combine": ROUNDS})
    # the EF entry point: ops.ef_topk_update over 5 steps of a 5-client
    # cohort at the simulation MLP's size, residuals carried
    paths["ef_topk_update"] = ef_entry_point(kern, zero, total)
    record["paths"] = paths
    return total


def ef_entry_point(kern, zero, total):
    from repro_torch.kernels import ops
    c, n = MAIN
    g = torch.Generator(device="cuda").manual_seed(11)
    grads = [torch.randn(c, n, device="cuda", generator=g)
             for _ in range(ROUNDS)]

    def steps():
        residual = torch.zeros(c, n, device="cuda")
        kept = []
        for grad in grads:
            outs = [ops.ef_topk_update(grad[i], residual[i], CR, block=BLOCK)
                    for i in range(c)]
            send = torch.stack([o[0] for o in outs])
            new_res = torch.stack([o[1] for o in outs])
            # corrected = send + residual' exactly (one of the two is 0)
            check(torch.equal(send + new_res, residual + grad),
                  "ef_topk_update: send + residual' == residual + grad")
            kept.append(int((send != 0).sum()))
            residual = new_res
        return kept

    t0 = time.perf_counter()
    kept, counts = drive(kern, steps)
    wall = time.perf_counter() - t0
    check_counts(counts, dict(zero, ef_update=ROUNDS * c), "ef_topk_update")
    for name, v in counts.items():
        total[name] += v
    print(f"[path] ef_topk_update: {ROUNDS} steps x {c} clients in "
          f"{wall:.4f} s, kept per step {kept}")
    return dict(steps=ROUNDS, clients=c, kept_per_step=kept, wall_s=wall,
                launches=counts)


# ------------------------------------------------------ reference check
def agg_bound(w, vals, gamma, c):
    """The client-sum reordering bound 2*C*2^-24*gamma*sum_c|w_c v_c|."""
    return 2 * c * 2.0 ** -24 * gamma * (w[:, None].double()
                                         * vals.double()).abs().sum(0)


def reference_check(record):
    """aggregate_updates through the kernels on the card against the plain
    path on the CPU, same inputs, every built-in strategy: EF residuals
    bit for bit, agg within the reordering bound of the client sum
    (|d| <= 2*C*2^-24*gamma*sum_c |w_c v_c|: the kernel adds clients in a
    fixed order, the plain path through einsum)."""
    from repro_torch.core import strategies
    from repro_torch.fed.engine import (ClientUpdateSpec, aggregate_updates,
                                        compress_batch_fn)
    c, n = MAIN
    rng = np.random.default_rng(3)
    u = torch.from_numpy(rng.normal(size=(c, n)).astype(np.float32))
    r = torch.from_numpy((0.3 * rng.normal(size=(c, n))).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.1, 1.0, c).astype(np.float32))
    ks = torch.from_numpy(rng.integers(1, n // 10, c).astype(np.int32))
    worst = 0.0
    for name in strategies.names():
        spec_k = ClientUpdateSpec(strategy=name, use_kernel=True)
        spec_p = ClientUpdateSpec(strategy=name, use_kernel=False)
        res = r if spec_k.needs_residuals else None
        agg_k, nr_k = aggregate_updates(
            spec_k, u.cuda(), w.cuda(), ks.cuda(),
            res.cuda() if res is not None else None)
        agg_p, nr_p = aggregate_updates(spec_p, u, w, ks, res)
        agg_k = agg_k.cpu()
        check(bool(torch.isfinite(agg_k).all()), f"{name}: finite agg")
        if res is not None:
            check(bits_equal(nr_k.cpu(), nr_p), f"{name}: EF residuals")
        corrected = u + res if res is not None else u
        vals = (compress_batch_fn(spec_p)(corrected, ks).values
                if spec_k.strat.compresses else corrected)
        gamma = spec_k.gamma if spec_k.strat.overlap_weighted else 1.0
        diff = (agg_k - agg_p).abs()
        check(bool((diff <= agg_bound(w, vals, gamma, c)).all()),
              f"{name}: agg within the summation-order bound")
        worst = max(worst, float(diff.max()))
    record["reference_check_max_abs_agg_diff"] = worst


def legacy_reference_check(record):
    """One legacy round at full width: the cohort's real MLP deltas (local
    SGD on the card), then ``aggregate(use_loop=True)`` through the kernels
    (block_topk per client, overlap_combine) against the exact plain route
    on the CPU, same deltas and residuals. Reports the mask disagreements
    (the kernel's value bisection against exact Top-K) and, where the masks
    agree, holds EF residuals bit for bit and agg within the bound."""
    from repro_torch.core import aggregation as agg_mod
    from repro_torch.core.compression import flatten_tree
    from repro_torch.fed import simulation as sim
    from repro_torch.fed.client import make_local_trainer
    cfg = sim.FLSimConfig()
    acfg0 = agg_mod.AggregationConfig(strategy="bcrs_opwa", block_topk=True)
    rng, clients, _, fracs, _, server = sim._setup_sim(cfg, acfg0, "cuda")
    steps = sim._steps_by_client(clients, cfg)
    selected, fr = sim.plan_cohort(
        0, rng, n_clients=cfg.n_clients, participation=cfg.participation,
        fracs_all=fracs, links=server.links, v_bytes=server.v_bytes,
        acfg=acfg0)
    train = make_local_trainer(sim.mlp_loss, cfg.lr)
    deltas = []
    for c in selected:
        xs, ys = clients[c].fixed_batches(cfg.batch_size, int(steps[c]), rng)
        d, _ = train(server.params, {"x": torch.as_tensor(xs, device="cuda"),
                                     "y": torch.as_tensor(ys, device="cuda")})
        deltas.append(flatten_tree(d))
    u = torch.stack(deltas)
    links = [server.links[i] for i in selected]
    g = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for s in LEGACY_STRATEGIES:
        a_k = agg_mod.AggregationConfig(strategy=s, block_topk=True)
        a_p = agg_mod.AggregationConfig(strategy=s, block_topk=True,
                                        use_kernel=False)
        res = (0.3 * float(u.std()) * torch.randn(
            u.shape, device="cuda", generator=g)
               if a_k.strat.needs_residuals else None)
        res_cpu = res.cpu() if res is not None else None
        crs, weights, _ = agg_mod.round_schedule(a_p, len(selected), fr,
                                                 links, server.v_bytes)
        vk, mk, nk = agg_mod.compress_clients_loop(u, crs, a_k, res)
        vp, mp, nrp = agg_mod.compress_clients_loop(u.cpu(), crs, a_p,
                                                    res_cpu)
        agree = (mk.cpu() == mp).all(dim=0)        # every client agrees
        disagree = int((mk.cpu() != mp).sum())
        agg_k, _, _ = agg_mod.aggregate(u, fr, a_k, links=links,
                                        v_bytes=server.v_bytes,
                                        residuals=res, use_loop=True)
        agg_p, _, _ = agg_mod.aggregate(u.cpu(), fr, a_p, links=links,
                                        v_bytes=server.v_bytes,
                                        residuals=res_cpu, use_loop=True)
        agg_k = agg_k.cpu()
        check(bool(torch.isfinite(agg_k).all()), f"legacy {s}: finite agg")
        if res is not None:
            check(bits_equal(nk.cpu()[:, agree], nrp[:, agree]),
                  f"legacy {s}: EF residuals where the masks agree")
        w = torch.as_tensor(np.asarray(weights, np.float32))
        gamma = a_p.gamma if a_p.strat.overlap_weighted else 1.0
        bound = agg_bound(w, vp, gamma, len(selected))
        diff = (agg_k - agg_p).abs()
        check(bool((diff[agree] <= bound[agree]).all()),
              f"legacy {s}: agg within the bound where the masks agree")
        out[s] = dict(mask_disagreements=disagree,
                      max_abs_agg_diff=float(diff[agree].max()),
                      max_bound=float(bound.max()),
                      max_diff_over_bound=float(
                          (diff[agree] / bound[agree].clamp_min(
                              1e-45)).max()))
        print(f"[reference legacy] {s}: mask disagreements {disagree}, "
              f"max |d agg| {out[s]['max_abs_agg_diff']:.3g} "
              f"(largest bound {out[s]['max_bound']:.3g})")
    record["legacy_reference_check"] = out


# -------------------------------------------------------------- profile
def profile_path(engine, acfg):
    """Where the device time of a path goes: ``run_fl`` (3 rounds, warm
    process) under ``torch.profiler``; device time summed by kernel name,
    and the busy share of the run's wall time. Reports "not measured" when
    the profiler shows no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.fed.simulation import FLSimConfig, run_fl
    rounds = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run_fl(FLSimConfig(rounds=rounds), acfg, engine=engine,
                     device="cuda")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.key_averages():
        # kernel events only: a CPU op's device time repeats its kernels'
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total:
            by_name[ev.key] = (ev.self_device_time_total / 1e3, ev.count)
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return dict(
        engine=engine, strategy=acfg.strategy, block_topk=acfg.block_topk,
        rounds=rounds, wall_ms_under_profiler=wall_ms,
        wall_per_round_ms_under_profiler=[t * 1e3 for t in
                                          res.wall_per_round],
        device_busy_ms=busy_ms if by_name else "not measured",
        device_idle_share=(1 - busy_ms / wall_ms) if by_name
        else "not measured",
        # against the rounds alone (setup and the first staging excluded;
        # the eval's few kernels stay in busy_ms)
        device_idle_share_of_rounds=(
            1 - busy_ms / (sum(res.wall_per_round) * 1e3)) if by_name
        else "not measured",
        top_kernels=[dict(name=k[:90], device_ms=v[0], calls=v[1])
                     for k, v in top])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full record as JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="also profile 3 rounds of the fused and the legacy "
                         "path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke "
              "run needs one CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    from repro_torch.kernels import block_topk as bt
    from repro_torch.kernels import build
    from repro_torch.kernels import ef_update as eu
    from repro_torch.kernels import fused_merge as fm
    from repro_torch.kernels import overlap_combine as oc
    from repro_torch.kernels import threshold_find as tf
    modules = {"threshold_find": tf, "fused_merge": fm, "overlap_combine": oc,
               "block_topk": bt, "ef_update": eu}
    kern = {name: getattr(mod, name) for name, mod in modules.items()}
    check(tuple(sorted(build.KERNELS)) == tuple(sorted(kern)),
          "chip_smoke covers every kernel that build.KERNELS lists")

    record = {"torch": torch.__version__, "cuda": torch.version.cuda}
    t0 = time.perf_counter()
    build.check_device()
    build.build()
    record["build_s"] = time.perf_counter() - t0
    print(f"[build] {len(build.KERNELS)} kernels in {record['build_s']:.1f} s")

    t0 = time.perf_counter()
    worst = kernel_parity(tf, fm, (MAIN, PRICED, LEAF, RAGGED), record)
    worst.update(block_parity(modules, record))
    print(f"[parity] {record['parity_cases']} + "
          f"{record['block_parity_cases']} cases bitwise equal "
          f"({time.perf_counter() - t0:.1f} s)")
    rows = kernel_timings(tf, fm, record) + block_timings(modules, record)
    for row in rows:
        print("[timing]", json.dumps(row))

    launches = run_paths(kern, record)
    check(all(n > 0 for n in launches.values()),
          f"every kernel launched on its path: {launches}")
    reference_check(record)
    print(f"[reference] aggregate_updates kernels vs plain path: max |d agg| "
          f"{record['reference_check_max_abs_agg_diff']:.3g}")
    legacy_reference_check(record)
    if args.profile:
        from repro_torch.core.aggregation import AggregationConfig
        record["profile"] = profile_path(
            "fused", AggregationConfig(strategy="bcrs_opwa"))
        record["profile_legacy"] = profile_path(
            "legacy", AggregationConfig(strategy="bcrs_opwa",
                                        block_topk=True))
        print("[profile]", json.dumps(record["profile"]))
        print("[profile legacy]", json.dumps(record["profile_legacy"]))

    # one row per kernel and shape; fused_merge's is the main path's OPWA
    main_rows = {r["kernel"]: r for r in rows if r["shape"] == "main"
                 and r["variant"] != "ef (eftopk)"}
    leaf_rows = {r["kernel"]: r for r in rows if r["shape"] == "leaf"
                 and r["variant"] != "ef (eftopk)"}
    sources = {
        "threshold_find": "src/repro/kernels/threshold_find.py:130",
        "fused_merge": "src/repro/kernels/fused_merge.py:112",
        "overlap_combine": "src/repro/kernels/overlap_combine.py:32",
        "block_topk": "src/repro/kernels/block_topk.py:45",
        "ef_update": "src/repro/kernels/ef_update.py:45"}
    kernels = []
    for name, replaces in sources.items():
        m, lf = main_rows[name], leaf_rows[name]
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{name}.cu",
            replaces=replaces, launches=launches[name],
            max_abs_err=worst[name], ms=m["ms"], plain_ms=m["plain_ms"],
            bound_ms=m["bound_ms"], bound_by=m["bound_by"],
            library_ms=m["library_ms"], leaf_ms=lf["ms"],
            leaf_plain_ms=lf["plain_ms"], leaf_bound_ms=lf["bound_ms"],
            leaf_library_ms=lf["library_ms"], parity="bitwise"))
    record["kernels"] = kernels
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    record["nvidia_smi"] = smi
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(record, device=device), f, indent=1)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
