"""Smoke run of the PyTorch/CUDA port on one Hopper card.

    python3 chip_smoke.py [--out PATH] [--profile]

1. builds the seven hand-written kernels (``src/repro_torch/csrc``; one
   nvcc per source, started together);
2. holds ``threshold_find`` and ``fused_merge`` bit for bit against their
   plain PyTorch twins, for every variant, at the main path's shape (C=5,
   n=136,724), the README's priced point (C=32, n=65,536), a real-model leaf
   (C=8, n=2048*5632, the stablelm-1.6b MLP matrix), a ragged edge (C=3,
   n=1001), the async merge's buffer (C=8) and the population cohort
   (C=16) at n=136,724, and ``threshold_find`` on adversarial rows (every k of a row of
   ties, all-zero / all-equal / denormal / NaN / +-inf / tied-at-k rows,
   n % 4 != 0, unaligned rows, C = 1 and 32), with its device activities a
   call counted under the profiler; ``block_topk``, ``ef_update`` and
   ``overlap_combine`` at the main shape, the leaf and a ragged shape
   (block 1000; C=3, n=1001), the row kernels also at block 32768 (their
   wide path), with edge rows (zeros, ties, huge, NaN, inf, a
   1e-15-under-1.0 row, denormals), and on ``adversarial_rows``
   (one hot first digit, last-digit neighbours at the k-th, patterns one
   ULP apart, ties across the k-th, ...) at blocks 1000, 1001, 8192, 16384,
   32768 and 65536 and on unaligned rows (every route of the two kernels);
   times kernel, twin and the nearest single PyTorch call with CUDA
   events, the row kernels also at [8, 32768] and [4, 262144];
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
5. the scan phase: ``threshold_find``, ``fused_merge`` and
   ``overlap_combine`` captured into a CUDA graph at the main shape and
   replayed bit-equal to their eager launches; then the whole-simulation
   engines at ``FLSimConfig()`` defaults (full width, 40 rounds):
   ``run_fl(engine="fused")`` and ``run_fl(engine="scan")`` in turn (fused,
   scan, scan, fused) under each of bcrs_opwa (with the Fig. 4 overlap
   round), eftopk, qtopk and int4, eftopk with a ``FailureInjector``
   (p = 0.6: padded cohort slots, rounds of one live client), block Top-K
   bcrs_opwa (``overlap_combine``),
   ``pop_scan`` eftopk and ``run_fl_traced``; scan held bit for bit to
   fused (accuracies, EF residuals, comm times, the histogram), one capture
   a simulation (two with the overlap round), launches counted replays
   included, the kernels' device activities a replay counted under the
   profiler with the replay loop's device-busy share, and a save/restore
   round trip of a scan's final model and residuals through the port's
   checkpointer; prints both engines' wall per round and each run's final
   accuracy;
6. the population / async phase, at the simulation MLP's full width:
   ``run_fl(engine="population")`` bit-equal to ``pop_scan`` (P = 10, 40
   rounds, eftopk and qtopk); ``population.run_population_rounds`` at
   P = 10^3 and 10^6 (cohort 16, 6 rounds, a bounded store window spilling
   to a temporary directory; peak state bytes equal across P), and at
   P = 10^3 against the same call on the plain route; the async
   sync anchor bit-equal to ``scan`` (bcrs_opwa) and ``pop_scan``
   (eftopk); a probe of whether a wave member's delta depends on the
   wave's width; the general async loop at the reference bench's dispatch
   shape (P = 64, K = 8, M = 32, 10 flushes), batched dispatch bit-equal
   to sequential, and its chaos case; a crash at half the flushes with the
   sparse store spilled and a resume bit-equal to the uninterrupted run;
   ``threshold_find`` and ``fused_merge`` counted once a round or flush;
7. the real-model FL phase (stablelm-1.6b at full width: 24 layers,
   d_model 2048, bf16, 1,644,267,520 parameters in 12 leaves, random
   weights from a seed): ``threshold_find`` and ``fused_merge`` bit for bit
   against their twins at the real leaf shapes (C = 8 x n = 276,824,064,
   the stacked w_up, and n = 205,520,896, the embedding, under OPWA; EF and
   EF + int8 at C = 4 x w_up; a padded slot in each: C * n up to 2.2e9 >
   2^31) and timed at the w_up leaf; one client's full-width gradient
   twice, bit for bit; ``launch.fl_train.run(engine="round")`` at the
   CLI's defaults (bcrs_opwa, C = 8, 4 rounds), eftopk at C = 4 (4
   rounds; its f32 residuals do not fit at C = 8) and bcrs_opwa at C = 8
   with ``fail_prob`` 0.3 (masked slots), all three at ``CUT_LAYERS`` of
   the 24 layers (full width), each kernel launched leaves x
   rounds, wall per round (first apart), peak memory and the merge's
   share of a round from CUDA events around each leaf's
   ``compress_merge_leaf``; then each of the three again through
   ``fl_train.run(engine="scan")``: one CUDA graph capture a run, each
   kernel launched 12 times a replay, params, EF residuals and losses
   bit for bit equal to the round engine's, the eager round, the replay
   wall a round, the capture's seconds and peak memory; two replays under
   the profiler (device idle share; at ``CUT_LAYERS``) and the device
   time the fail run's masked slots cost; one round's deltas from the
   eftopk state through the kernel and the plain route of
   ``compress_merge_leaf`` (masks, ks, residuals bitwise; agg within
   2*C*2^-24*sum|w v|; new bf16 params within one ULP); ``fl_train
   --population`` (bcrs_opwa, P = 10,000, cohort 8, 3 rounds; at
   ``CUT_LAYERS`` layers) and ``--engine async`` (bcrs_opwa, K = M = 2, a
   version ring of 2, 3 flushes) at full width, launches counted, the
   async run's first flush (the whole raveled model, [2, n], C*n = 3.3e9)
   held against both kernels' twins bit for bit; restarts
   at ``reduced()`` depth and width equal to uninterrupted runs bit for
   bit: the round engine (eftopk, 3 rounds then resume to 6), population
   and async (eftopk over a sparse client store, the store included);
8. the centralised training phase (``launch.train`` at stablelm-1.6b's
   full width cut to ``CUT_LAYERS`` of its 24 layers, the CLI's defaults: B = 8, S = 256, lr 1e-2, seed 0):
   dense sgd and ``--compressed-pods 4 --wire-cr 0.05`` (bcrs_opwa, sgd),
   4 steps each, with the counts reset just before and read just after
   (no merge launch dense; ``threshold_find`` and ``fused_merge`` once per
   leaf of at least 4096 elements a step compressed, EF residuals nonzero
   on those leaves), the wall a step, peak memory, the merge's ms a step
   and one more step under the profiler; one step's pod gradients
   through both routes of ``compress_merge_leaf`` (thresholds bitwise
   against the twin, masks, ks and EF residuals bitwise, agg within
   2*C*2^-24*gamma*sum|w v|); ``wire_cr = 1`` at 2 pods against the dense
   step over the same slices (EF exactly 0, params within the bound of
   ``tests/test_torch_grad_sync.py``); at ``CUT_LAYERS`` of the 24
   layers (full width), adamw dense and at 2 pods and qtopk (int8 codec
   stage) at 4 pods, 2 steps each and one profiled; restarts at
   ``reduced()`` size (dense adamw, compressed) equal to uninterrupted
   runs bit for bit;
9. the serve phase (stablelm-1.6b at full width, bf16, random weights from
   a seed): the present ``flash_attention`` kernel against its twin
   (within the summation-order bound, plus one bf16 ULP in bf16, and bf16
   equal to the f32 kernel on the upcasts, rounded) and the bf16 wgmma
   kernel against its twin and that twin against the f32 twin (within
   ``wgmma_twin_and_bound``, plus one bf16 ULP; the check must reject a
   planted fault, one key tile skipped) at the serve shape [4, 2048, 32, 64]
   (bf16 and f32), yi-9b's heads (D = 128, kv broadcast from 4 heads), a
   ragged S = 1000 and Sq 700 x Sk 1000, Sq 128 x Sk 384, a non-causal case
   and one 32k sequence of ``prefill_32k``, timed beside their twins and
   ``F.scaled_dot_product_attention``; ``ops.flash_attention`` on layer 0's
   own q, k, v of a 2048-token prompt against ``attention.attend`` (bf16
   through the wgmma kernel, f32 through the present one, launches
   counted); and ``launch.serve.generate``: a 128-token prompt stepped
   through ``decode_step`` at B = 4, 32 greedy tokens, and
   ``Model.prefill`` over the same prompt against the decode logits;
10. the recurrent serve phase (hymba-1.5b and rwkv6-1.6b at full width,
   bf16, random weights from a seed; none of the kernels runs there):
   ``launch.serve.generate`` as in 9, launches counted (zero), finite
   logits, the bf16 prefill-vs-decode gap recorded; the same params upcast
   to f32 and cut to their first ``CUT_LAYERS`` layers, ``Model.prefill``
   over a 256-token prompt (two GLA chunks)
   against ``generate``'s stepped decode on an f32 cache within the
   counted f32 bound ``6 * 2^-24 * sqrt(L * R * d_ff) * rms(logits)``;
   decode ms a step beside its byte bound (weights, KV cache, the
   recurrent state read and written), peak memory; ``Model.prefill`` at
   2048 tokens;
   ``chunked_gla`` over 4 chunks of layer 0's own inputs (hymba: scalar,
   inclusive, 50 heads, Dk 16, Dv 64; rwkv6: per-channel decay and bonus,
   32 heads of 64) against ``reference_recurrence`` within
   ``gla.summation_bound`` (its log-decay term from each chunk's
   ``sum |g|``, the largest printed);
11. the recurrent training phase (hymba-1.5b and rwkv6-1.6b at full
   width cut to ``CUT_LAYERS`` of their 32 / 24 layers, bf16, seed 0, ``remat="full"``; ``launch.train``'s defaults:
   B = 8, S = 256, two GLA chunks): one batch's gradient twice, bit for
   bit; the loss and every gradient under ``remat`` "none", "full" and
   "dots", bit for bit, with each mode's peak memory; ``launch.train``
   dense sgd, 4 steps (no merge launch, wall a step, peak memory, a
   profiled step); hymba only, at ``CUT_LAYERS`` of its 32 layers (full
   width): ``--compressed-pods 4 --wire-cr 0.05``, 4
   steps (``threshold_find`` and ``fused_merge`` once per leaf of at
   least 4096 elements a step, EF residuals nonzero there, the merge's ms
   a step, one step's pod gradients through both merge routes), and
   ``fl_train`` at its defaults (bcrs_opwa, C = 8, 4 rounds) through the
   round engine (launches leaves x rounds, wall, peak, the merge's share,
   losses per round) and the mesh scan (one captured CUDA graph a round,
   the checkpointed backward inside it; bit for bit against the round
   engine);
12. the cross-attention phase (whisper-medium, encdec, and
   llama-3.2-vision-11b, vlm, at full width, bf16, seed 0; whisper whole,
   the vlm at 2 of its 8 groups throughout; the vlm's
   cross gates set to 0.7 / -0.4, since at their initial zeros every cross
   block is the identity): ``launch.serve.generate`` as in 9 (zero
   launches; the cross caches stay zero, as the reference serves them),
   decode ms a step beside its byte bound (the cross caches read whole),
   3 decode steps under the profiler; ``Model.prefill`` at the model's
   own shape (whisper: 1500 frames, 448 tokens; the vlm: 2048 tokens over
   1024 patches); the params upcast to f32 (the vlm at 2 of its 8
   groups), ``Model.prefill`` against the stepped decode over cross
   caches filled here from the same frames or patches, within
   ``6 * 2^-24 * sqrt(L * R * K) * rms(logits)``, the served decode (zero
   cross caches) failing it; ``launch.train`` dense sgd 4 steps and ``--compressed-pods`` (whisper 4 at ``CUT_LAYERS``,
   the vlm 2 at 2 of 8 groups) 4 steps, launches, wall,
   peak, the merge's ms;
   whisper's gradient twice and under the three remat modes bit for bit;
   one step's pod gradients through both merge routes and through
   ``threshold_find`` / ``fused_merge`` against their twins, bit for bit,
   on every compressed leaf (the vlm's ``[G, per, d, d_ff]`` ones
   included); nothing left resident on the card before the vlm;
13. with ``--profile``, profiles 3 rounds of the fused and of the legacy
   path, of the population engine and 3 flushes of the async engine
   (eftopk), one full-width local SGD step of ``fl_train`` (also timed in
   parts: forward, backward, update) and 3 decode steps of each serve path
   (stablelm, hymba, rwkv6: device time by kernel, idle share), and the
   row kernels' device time a call at the main shape;
14. the moe phase (deepseek-v3-671b, MLA with its latent-cache decode and
   MTP, and kimi-k2-1t-a32b, GQA; bf16, seed 0): each served at full
   width, every expert and top-8 kept, its depth cut to one whole period
   (deepseek 4 of 61 layers: its 3 dense and 1 MoE; kimi 2 of 61: 1 dense,
   1 MoE): ``launch.serve.generate`` as in 9 (zero launches), decode ms a
   step beside its byte bound (every expert read: the dense ``[E, C, d]``
   dispatch), 3 profiled decode steps, ``Model.prefill`` at 4 x 2048 with
   its dropped (token, slot) pairs counted, peak memory, the bf16
   prefill-vs-decode gap recorded; deepseek upcast to f32 leaf by leaf
   (its MTP head dropped), ``Model.prefill`` at 1 x 8 against the stepped
   decode on an f32 cache: no drop, the same experts for every token with
   each top-8 margin above twice its bound, the logits within ``6 * 2^-24
   * sqrt(L * 21 * d_ff) * rms``, and a decode that never stores its rope
   key or sends the second routing slot to the next expert failing it;
   deepseek's MoE layer alone at full width (T = 2048, capacity 80), its
   every gradient twice, bit for bit; each model at ``reduced()`` size:
   one gradient twice and the three remat modes bit for bit,
   ``launch.train`` dense sgd and ``--compressed-pods 2 --wire-cr 0.1``, 4
   steps each, both merge kernels against their twins bit for bit on every
   compressed leaf (the expert stacks among them); deepseek's ``fl_train
   --reduced`` through the round engine and the mesh scan (one captured
   CUDA graph a round), bit for bit;
15. the layout phase (the multi-card layout, ``dist.sharding`` and
   ``launch.specs``; run right after the timings of 2, while this process
   holds nothing on the card but its context): 4 ranks, rank r on card ``r % device_count`` (NCCL
   when each has a card; gloo when they share one, with DTensor's
   collectives routed through c10d's and every leaf merged on rank 0,
   its shares moved by CUDA IPC; the backend, world size and cards
   printed), qwen2.5-32b at full width cut to 2 of its 64 layers (2.54e9
   parameters; the cut keeps the whole model's FSDP flag) on a (data 2,
   model 2) mesh, B = 8, S = 256, the params drawn straight into their
   layout (``launch.specs.init_params``): the f32 loss and every gradient
   against the single-process port's on the same card within ``6 *
   2^-24 * sqrt(K) * max|g|`` (each leaf's ratio printed), one gradient
   with a zeroed shard and rounded to bf16 each failing it; the bf16
   ``train`` cell twice, the same bits, wall a step, per-rank peak; the
   ``train_compressed`` cell (2 pods, wire_cr 0.05) with ``threshold_find``
   and ``fused_merge`` against their twins on every compressed leaf's
   gathered pod gradients and the one-process merge's update and residuals
   equal to the step's shards, bit for bit; the ``fl_round`` cell (2
   clients, 2 local steps), finite; launches summed over the ranks.

Any failed check exits nonzero. The last two lines are the ``kernels`` JSON
and ``{"ok": true, "device": ...}``. Needs CUDA and the repository's
``src/``; ``--out`` also writes the full record as JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
MAIN = (5, 136_724)           # cohort x simulation-MLP parameters
PRICED = (32, 65_536)
LEAF = (8, 2048 * 5632)       # stablelm-1.6b MLP matrix as one [C, n] leaf
RAGGED = (3, 1001)
ASYNC_BUFFER = (8, MAIN[1])   # the async merge at the bench's K = 8
POP_COHORT = (16, MAIN[1])    # run_population_rounds' cohort of 16
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
#: rows wider than the block kernels hold in registers (the wide path), and
#: a longer one
BLOCK_WIDE = (8, 32768)
BLOCK_LONG = (4, 262144)
#: widths of the block kernels' adversarial rows: the register path with
#: float4 access (1000, the default, the widest register row) and without
#: (1001), and the wide path, which re-reads the row in each pass (32768,
#: 65536)
ADVERSARIAL_BLOCKS = (1000, 1001, BLOCK, 16384, BLOCK_WIDE[1], 65536)
#: threshold_find's large tie-heavy adversarial rows
BIG_TIES = (8, 1 << 21)


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


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after ``warmup``
    calls."""
    for _ in range(warmup):
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
    cases, reads = 0, {}
    for seed, (c, n) in enumerate(shapes):
        x, e, ks, w, active = make_case(c, n, seed)
        for ef in (False, True):
            ee = e if ef else None
            tf.threshold_find.reads_log = []
            th, am = tf.threshold_find(x, ks, ee, emit_scale=True)
            th2 = tf.threshold_find(x, ks, ee)
            reads[f"C={c} n={n} ef={ef}"] = reads_of_x(
                tf.threshold_find.reads_log)
            tf.threshold_find.reads_log = None
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
    record["threshold_parity_reads_of_x"] = reads
    print(f"[parity] threshold_find reads of x per client {reads}")
    return worst


def threshold_rows():
    """Adversarial inputs of ``threshold_find`` as (label, x, e, ks): every
    k of a row of ties (C = 64 copies, k = 1..64); C = 32 rows of n = 4099
    (n % 4 != 0: the scalar path) that are all zero, all equal, denormal,
    NaN-strewn, all NaN, +-inf, tied at the k-th value, huge, signed zeros,
    consecutive patterns (the last digit decides) and the 4099 smallest
    patterns, with k = 1 and k = n among them; rows that start 4 bytes past
    a 16-byte boundary; C = 1 at n = 1 and n = 3."""
    g = torch.Generator(device="cuda").manual_seed(21)
    cases = []
    row = torch.randint(-3, 4, (64,), device="cuda", generator=g) * 0.5
    cases.append(("every k of a row of ties",
                  row.float().repeat(64, 1).contiguous(), None,
                  torch.arange(1, 65, device="cuda", dtype=torch.int32)))
    c, n = 32, 4099
    x = torch.randn(c, n, device="cuda", generator=g)
    x[0] = 0.0
    x[1] = 1.5
    x[2] *= 1e-40
    x[3, ::7] = float("nan")
    x[4, ::5] = float("inf")
    x[4, 1::5] = float("-inf")
    x[5, :2000] = x[5, 0]
    x[6] *= 1e30
    x[7] = 0.0
    x[7, ::2] = -0.0
    x[7, :3] = torch.tensor([1.0, -1.0, 2.0], device="cuda")
    x[8] = float("nan")
    x[9] = 1.0 + torch.arange(n, device="cuda") * 2.0 ** -23
    x[10] = torch.arange(n, device="cuda", dtype=torch.int32).view(
        torch.float32)
    ks = torch.randint(1, n + 1, (c,), device="cuda", generator=g,
                       dtype=torch.int32)
    ks[0], ks[1], ks[5], ks[7], ks[30], ks[31] = 1, n, 1500, 10, 1, n
    e = 0.3 * torch.randn(c, n, device="cuda", generator=g)
    e[1] = 0.0
    e[2] *= 1e-40
    e[3] = -x[3].nan_to_num(0.0)              # cancellations to +-0
    cases += [("C=32 n=4099 edge rows", x, None, ks),
              ("C=32 n=4099 edge rows + e", x, e, ks)]
    buf = torch.randn(3 * 1000 + 1, device="cuda", generator=g)
    ebuf = torch.randn(3 * 1000 + 1, device="cuda", generator=g)
    xu, eu_ = buf[1:].view(3, 1000), ebuf[1:].view(3, 1000)
    ku = torch.tensor([1, 617, 1000], device="cuda", dtype=torch.int32)
    cases += [("unaligned rows", xu, None, ku),
              ("unaligned rows + e", xu, eu_, ku)]
    cases.append(("C=1 n=1", torch.tensor([[-2.5]], device="cuda"), None,
                  torch.tensor([1], device="cuda", dtype=torch.int32)))
    cases.append(("C=1 n=3", torch.tensor(
        [[float("nan"), 1.0, float("-inf")]], device="cuda"), None,
        torch.tensor([2], device="cuda", dtype=torch.int32)))
    # large, tie-heavy rows: rows 0-3 hold 90% exact zeros, rows 4-5 a
    # value repeated over half the row; k lands in the tie for some rows
    # (a bin too large to compact: 3 reads) and past it for others (2)
    c, n = BIG_TIES
    x = torch.randn(c, n, device="cuda", generator=g)
    x[:4, : n * 9 // 10] = 0.0
    x[4:6, ::2] = 1.5
    ks = torch.tensor([n // 2, n // 20, n, 1, n // 4, n // 10, n // 10, 7],
                      device="cuda", dtype=torch.int32)
    cases.append((f"C={c} n={n} tie-heavy rows", x, None, ks))
    return cases


def reads_of_x(log):
    """The reads of x the kernel reported per client, over the calls that
    ``threshold_find.reads_log`` collected: {2: clients, 3: clients}."""
    got = torch.cat(log).tolist() if log else []
    return {r: got.count(r) for r in sorted(set(got))}


def threshold_adversarial(tf, record):
    """``threshold_find`` on ``threshold_rows``: thresholds and absmax bit
    for bit against the twin, with the reads of x each client took; the
    tie-heavy case must take both branches (2 and 3 reads)."""
    n_cases, reads = 0, {}
    for label, x, e, ks in threshold_rows():
        tf.threshold_find.reads_log = []
        th, am = tf.threshold_find(x, ks, e, emit_scale=True)
        th2 = tf.threshold_find(x, ks, e)
        tf.threshold_find.reads_log, log = None, tf.threshold_find.reads_log
        tp, ap = tf.threshold_find_plain(x, ks, e, emit_scale=True)
        torch.cuda.synchronize()
        check(torch.equal(th, tp) and torch.equal(th2, tp),
              f"threshold_find {label}: thresholds")
        check(bits_equal(am, ap), f"threshold_find {label}: absmax")
        reads[label] = reads_of_x(log)
        if "tie-heavy" in label:
            check(set(reads[label]) == {2, 3},
                  f"threshold_find {label}: both branches, {reads[label]}")
        n_cases += 1
    record["threshold_adversarial_cases"] = n_cases
    record["threshold_adversarial_reads_of_x"] = reads
    print(f"[parity] threshold_find adversarial rows: {n_cases} cases "
          f"bitwise equal; reads of x per client {reads}")


def threshold_launches_per_call(tf, record):
    """Device activities (kernels and memsets) of one ``threshold_find``
    call at the main shape, under ``torch.profiler``: at most 4 (the source
    note's count: one memset, three passes); "not measured" when the
    profiler shows no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    c, n = MAIN
    x = torch.randn(c, n, device="cuda")
    ks = torch.full((c,), n // 10, device="cuda", dtype=torch.int32)
    tf.threshold_find(x, ks)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tf.threshold_find(x, ks)
        torch.cuda.synchronize()
    names = [ev.name for ev in prof.events()
             if ev.device_type == DeviceType.CUDA]
    if names:
        check(len(names) <= 4, f"threshold_find: {len(names)} device "
                               f"activities a call ({names}), at most 4")
    record["threshold_find_launches_per_call"] = (
        dict(count=len(names), names=names) if names else "not measured")
    print(f"[threshold_find] device activities a call: "
          f"{len(names) if names else 'not measured'} {names}")


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


def adversarial_rows(block: int, k: int, seed: int) -> np.ndarray:
    """16 f32 rows of ``block`` (seeded numpy; also the CPU tests' rows) on
    which a value bisection differs from exact Top-K or a radix select can
    slip: zeros, ties, huge values, NaN, +-inf, the k-th magnitude below
    rowmax*2^-40, all denormal, mids falling to denormals, denormal halves,
    signed zeros, a run of ties across the k-th, patterns one ULP apart
    across 1.0 (every digit decides), neighbours that differ only in the
    last digit, one hot first digit (all in [1, 2)), delta-like magnitudes
    (a few exponents) and last-digit neighbours around the k-th among small
    values."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(16, block)).astype(np.float32)
    sign = np.where(rng.random((16, block)) < 0.5, -1, 1).astype(np.float32)
    ar = np.arange(block)
    x[0] = 0.0                                    # all zeros
    x[1, : block // 2] = x[1, 0]                  # ties
    x[2] *= np.float32(1e30)                      # huge
    x[3, 5 % block] = np.nan                      # NaN: rowmax NaN
    x[4, 7 % block], x[4, 3 % block] = np.inf, -np.inf
    x[5] = 0.0                                    # k-th below rowmax*2^-40
    x[5, 0], x[5, 1:21] = 1.0, 1e-15
    x[6] *= np.float32(1e-40)                     # all denormal
    x[7] = 0.0                                    # mids fall to denormals
    x[7, :20] = 2e-38
    x[8, : block // 2] *= np.float32(1e-40)       # denormal half
    x[8, ::7] = -0.0
    x[9, rng.random(block) < 0.5] = -0.0          # signed zeros
    x[9, rng.random(block) < 0.25] = 0.0
    order = np.argsort(-np.abs(x[10]), kind="stable")
    run = order[max(0, k - 4): k + 3]             # ties across the k-th
    x[10, run] = np.copysign(np.abs(x[10, order[k - 1]]), x[10, run])
    ulps = np.uint32(0x3F800000 - block // 2) + rng.permutation(block)
    x[11] = ulps.astype(np.uint32).view(np.float32) * sign[11]
    last = np.uint32(0x3F800000) + rng.integers(0, 128, block)
    x[12] = last.astype(np.uint32).view(np.float32) * sign[12]
    x[13] = (1.0 + rng.random(block)).astype(np.float32) * sign[13]
    x[14] *= np.float32(1e-3)
    x[15] *= np.float32(1e-4)
    near = rng.permutation(block)[: min(block, 2 * k)]
    x[15, near] = (np.uint32(0x3C000000) + (ar[: near.size] % 128)).astype(
        np.uint32).view(np.float32) * sign[15, near]
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
    """block_topk and ef_update at the main, leaf, ragged and wide (block
    32768) rows and on the adversarial rows at ``ADVERSARIAL_BLOCKS`` (k =
    1, the default ratio's k, k = block), overlap_combine at the main, leaf
    and ragged [C, n] (gamma 5 / d 1 and gamma 1 / d 2): bitwise."""
    from repro_torch.core.compression import k_for_ratio
    bt, eu, oc = mods["block_topk"], mods["ef_update"], mods["overlap_combine"]
    worst = {"block_topk": 0.0, "ef_update": 0.0, "overlap_combine": 0.0}
    cases = 0
    for seed, (nb, block) in enumerate((BLOCK_MAIN, BLOCK_LEAF,
                                        BLOCK_RAGGED, BLOCK_WIDE)):
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
    # rows that a radix select can slip on (adversarial_rows: one hot first
    # digit, last-digit neighbours at the k-th, patterns one ULP apart
    # across 1.0, ties across the k-th, ...), register and wide
    adversarial = 0
    for block in ADVERSARIAL_BLOCKS:
        for k in sorted({1, k_for_ratio(block, CR), block}):
            x = torch.from_numpy(adversarial_rows(block, k, block + k))
            x = x.to("cuda")
            g = torch.Generator(device="cuda").manual_seed(block + k)
            e = 0.3 * torch.randn(x.shape, device="cuda", generator=g)
            e[0] = -x[0]
            e[8, :20] = 1e-40
            got, want = bt.block_topk(x, k), bt.block_topk_plain(x, k)
            torch.cuda.synchronize()
            check(bits_equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                  f"block_topk adversarial rows block={block} k={k}")
            got, want = eu.ef_update(x, e, k), eu.ef_update_plain(x, e, k)
            torch.cuda.synchronize()
            for g_, w_ in zip(got, want):
                check(bits_equal(g_, w_),
                      f"ef_update adversarial rows block={block} k={k}")
            adversarial += 2
    # a row that starts 4 bytes past a 16-byte boundary: the scalar path
    x = torch.randn(8 * BLOCK + 1, device="cuda")[1:].view(8, BLOCK)
    k = k_for_ratio(BLOCK, CR)
    got, want = bt.block_topk(x, k), bt.block_topk_plain(x, k)
    check(bits_equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "block_topk unaligned rows")
    got, want = eu.ef_update(x, x.flip(0), k), eu.ef_update_plain(
        x, x.flip(0), k)
    check(all(bits_equal(g_, w_) for g_, w_ in zip(got, want)),
          "ef_update unaligned rows")
    adversarial += 2
    record["block_adversarial_cases"] = adversarial
    cases += adversarial
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
               library_ms, ops_per_s=F32_OPS_PER_S):
    """One timing record with its bound: the larger of bytes over the HBM
    rate and operations over the peak rate of their type (f32 unless
    given)."""
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = ops / ops_per_s * 1e3
    return dict(kernel=kernel, shape=shape, variant=variant, bytes=nbytes,
                ops=ops,
                bound_by="bytes" if bound_bytes >= bound_ops else "operations",
                bound_ms=max(bound_bytes, bound_ops), ms=ms,
                plain_ms=plain_ms, library=library, library_ms=library_ms)


def row_kernel_rows(bt, eu, label, nb, block, reps):
    """block_topk and ef_update on [nb, block] rows at the default ratio's
    k: kernel, twin and torch.topk with CUDA events, and their bounds."""
    from repro_torch.core.compression import k_for_ratio
    g = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn(nb, block, device="cuda", generator=g)
    e = 0.3 * torch.randn(nb, block, device="cuda", generator=g)
    mag = x.abs()
    k = k_for_ratio(block, CR)
    elems = nb * block
    variant = f"[{nb}, {block}] k={k}"
    topk = "torch.topk(|x|, k, dim=1)"
    few = max(3, reps // 5)
    # x read once, vals + int8 mask written once (9 B); 4 digit passes of a
    # shift and a compare, and the mask's compare (9 operations)
    rows = [timing_row(
        "block_topk", label, variant, elems * 9, elems * 9,
        time_ms(lambda: bt.block_topk(x, k), reps),
        time_ms(lambda: bt.block_topk_plain(x, k), few), topk,
        time_ms(lambda: torch.topk(mag, k, dim=1), reps))]
    # g, e read once, send, residual' written once (16 B); the same 9
    # operations, the add and the subtract
    rows.append(timing_row(
        "ef_update", label, variant, elems * 16, elems * 11,
        time_ms(lambda: eu.ef_update(x, e, k), reps),
        time_ms(lambda: eu.ef_update_plain(x, e, k), few), topk,
        time_ms(lambda: torch.topk(mag, k, dim=1), reps)))
    return rows


def row_kernel_device_ms(bt, eu, nb, block, calls=20):
    """Device time a call of block_topk's and ef_update's kernels on
    [nb, block] rows under torch.profiler (the event-timed call at the main
    shape is the host's); "not measured" when the profiler shows none."""
    from repro_torch.core.compression import k_for_ratio
    g = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn(nb, block, device="cuda", generator=g)
    e = 0.3 * torch.randn(nb, block, device="cuda", generator=g)
    k = k_for_ratio(block, CR)
    out = {}
    for name, fn in (("block_topk", lambda: bt.block_topk(x, k)),
                     ("ef_update", lambda: eu.ef_update(x, e, k))):
        fn()
        torch.cuda.synchronize()
        _, _, by_name = device_profile(
            lambda: [fn() for _ in range(calls)])
        ms = [t for key, (t, _) in by_name.items() if name + "_" in key]
        out[name] = sum(ms) / calls if ms else "not measured"
    return out


def block_timings(mods, record, profile=False):
    """block_topk, ef_update and overlap_combine at the main path's shape
    and at the leaf, the row kernels also at their wide path ([8, 32768])
    and a longer row ([4, 262144]): kernel, twin and library call with CUDA
    events; with ``profile``, the row kernels' device time a call at the
    main shape."""
    bt, eu, oc = mods["block_topk"], mods["ef_update"], mods["overlap_combine"]
    rows = []
    for label, (nb, block), (c, n), reps in (
            ("main", BLOCK_MAIN, MAIN, 50), ("leaf", BLOCK_LEAF, LEAF, 10)):
        rows += row_kernel_rows(bt, eu, label, nb, block, reps)
        few = max(3, reps // 5)
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
    for label, (nb, block) in (("wide", BLOCK_WIDE), ("long", BLOCK_LONG)):
        rows += row_kernel_rows(bt, eu, label, nb, block, 20)
    torch.cuda.empty_cache()
    record["block_timings"] = rows
    if profile:
        record["block_device_ms_per_call"] = row_kernel_device_ms(
            bt, eu, *BLOCK_MAIN)
        print("[profile block kernels, main shape, device ms a call]",
              json.dumps(record["block_device_ms_per_call"]))
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
    from repro_torch.kernels import threshold_find as tf
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

    # the fused engine, global Top-K: threshold_find + fused_merge a round,
    # with the reads of x each threshold_find call took per client
    tf.threshold_find.reads_log = []
    for s in STRATEGIES:
        one_run(f"fused {s}", AggregationConfig(strategy=s), "fused",
                {"threshold_find": ROUNDS, "fused_merge": ROUNDS})
    log, tf.threshold_find.reads_log = tf.threshold_find.reads_log, None
    per_call = [int(r.max()) for r in log]
    check(len(log) == ROUNDS * len(STRATEGIES),
          f"threshold_find reported its reads of x on {len(log)} calls")
    record["main_path_reads_of_x"] = dict(
        calls=len(log), per_client=reads_of_x(log),
        per_call_max=max(per_call), per_call_mean=sum(per_call) / len(log))
    print(f"[path] threshold_find on the fused paths: reads of x "
          f"{record['main_path_reads_of_x']}")
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


# ------------------------------------------------------------ scan phase
#: kernel names of the scan path's device activities, by wrapper
SCAN_KERNELS = {"threshold_find": ("radix_pass",),
                "fused_merge": ("merge_vec4", "merge_scalar"),
                "overlap_combine": ("combine_scalar", "combine_vec")}


def graph_replay_parity(tf, fm, oc, record):
    """The scan path's three kernels captured into a CUDA graph at the main
    path's shape, replayed, and held bit for bit against their eager
    launches on the same inputs (what the scan engine's replays rely on)."""
    from repro_torch.kernels import build
    c, n = MAIN
    x, e, ks, w, active = make_case(c, n, 7)
    masks = (torch.rand(c, n, device="cuda") < 0.3).to(torch.int8)
    vals = x * masks

    def calls():
        th = tf.threshold_find(x, ks, e)
        agg, res = fm.fused_merge(x, th, w, e, active, opwa=True, gamma=5.0)
        return th, agg, res, oc.overlap_combine(vals, masks, w, 5.0, 1)

    eager = calls()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with build.captured_launches() as per_replay:
        with torch.cuda.graph(graph):
            static = calls()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    for name, a, b in zip(("threshold_find", "fused_merge agg",
                           "fused_merge residual", "overlap_combine"),
                          static, eager):
        check(bits_equal(a, b), f"{name}: graph replay == eager launch")
    counts = {f.__name__: k for f, k in per_replay.items()}
    check(counts == {"threshold_find": 1, "fused_merge": 1,
                     "overlap_combine": 1},
          f"launches captured a replay: {counts}")
    record["graph_replay_parity"] = dict(cases=4, launches_per_replay=counts)
    print(f"[graph] threshold_find, fused_merge (agg, residual) and "
          f"overlap_combine replayed bit-equal to eager; per replay {counts}")


def scan_kernel_activities(res, prof):
    """A profiled scan run's device activities of the scan path's kernels,
    by kernel name, over the whole run (warm-up rounds and replays), its
    graph launches on the host, and the device-busy share of the replay
    loop: device time from the first graph launch for the loop's measured
    wall (the profiler's device clock is mapped onto the host's, so the
    window's edges are approximate). None when the profiler shows no graph
    launch."""
    from torch.autograd import DeviceType
    evs = prof.events()
    launches = [ev.time_range.start for ev in evs
                if ev.device_type == DeviceType.CPU
                and "GraphLaunch" in ev.name]
    if not launches:
        return None
    device = [ev for ev in evs if ev.device_type == DeviceType.CUDA]
    counts = {name: sum(any(p in ev.name for p in pats) for ev in device)
              for name, pats in SCAN_KERNELS.items()}
    counts["memset"] = sum("emset" in ev.name for ev in device)
    t0 = min(launches)
    t1 = t0 + sum(res.wall_per_round) * 1e6          # us, as the profiler
    busy_us = sum(ev.time_range.end - ev.time_range.start for ev in device
                  if t0 <= ev.time_range.start <= t1)
    return dict(activities=counts, graph_launches=len(launches),
                device_busy_ms_per_round=busy_us / 1e3 / len(launches),
                wall_ms_per_round=res.wall_per_round[0] * 1e3,
                device_busy_share=busy_us / (t1 - t0))


def scan_phase(kern, zero, record):
    """The whole-simulation engines at ``FLSimConfig()`` defaults (full
    width, 40 rounds): for each of ``STRATEGIES`` fused, scan, scan, fused
    in turn (bcrs_opwa with the Fig. 4 overlap round), then eftopk with
    failures, block Top-K bcrs_opwa, pop_scan eftopk and ``run_fl_traced``;
    each run's launches counted (replays included), scan held bit for bit
    to fused, one capture a simulation (two with the overlap round); two
    scan runs under the profiler count the kernels' device activities a
    replay; a save/restore round trip of a scan's final model and
    residuals. Returns the launches summed over the runs, per kernel."""
    import statistics
    import tempfile
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from repro_torch.checkpoint import checkpointer
    from repro_torch.core.aggregation import AggregationConfig
    from repro_torch.fed import engine as eng
    from repro_torch.fed import simulation as simmod
    from repro_torch.ft import FailureInjector
    sim = simmod.FLSimConfig()
    total = dict(zero)
    runs = {}
    global_route = {"threshold_find": 1, "fused_merge": 1}

    def one(label, engine, acfg, per_round, overlap=False, **kw):
        caps0 = sum(eng.CAPTURE_COUNTS.values())
        if engine == "traced":
            fn = lambda: simmod.run_fl_traced(sim, acfg, device="cuda", **kw)
        else:
            fn = lambda: simmod.run_fl(sim, acfg, engine=engine,
                                       device="cuda", collect_overlap=overlap,
                                       **kw)
        res, counts = drive(kern, fn)
        caps = sum(eng.CAPTURE_COUNTS.values()) - caps0
        accs = [a for _, a in res.accuracies]
        check(all(math.isfinite(v) for v in res.losses + accs),
              f"{label}: finite losses and accuracies")
        if res.final_residuals is not None:
            check(bool(np.isfinite(res.final_residuals).all()),
                  f"{label}: finite residuals")
        if engine == "fused":
            rounds, variants = len(res.executed_rounds), 0
            want = {k: v * rounds for k, v in per_round.items()}
            walls = [t * 1e3 for t in res.wall_per_round[1:]]
        else:
            # replays of the main graph, plus the warm-up rounds of each
            # captured variant (an overlap round is a second graph)
            replays = (sim.rounds if engine == "traced"
                       else len(res.executed_rounds))
            variants = 1 + int(overlap)
            want = {k: v * (replays + eng.WARMUP * variants)
                    for k, v in per_round.items()}
            walls = [res.wall_per_round[0] * 1e3]
            check(caps == variants,
                  f"{label}: {caps} captures, expected {variants}")
        if overlap:     # the overlap round's global Top-K on the raw deltas
            want["threshold_find"] += 1 + eng.WARMUP * (engine != "fused")
        check_counts(counts, dict(zero, **want), label)
        for name, n in counts.items():
            total[name] += n
        runs.setdefault(label, []).append(dict(
            engine=engine, accuracies=res.accuracies,
            final_accuracy=res.final_accuracy,
            executed_rounds=len(res.executed_rounds), captures=caps,
            wall_ms_per_round=walls,
            wall_ms_per_round_median=statistics.median(walls),
            launches={k: v for k, v in counts.items() if v}))
        return res

    def same(a, b, what):
        check([x for _, x in a.accuracies] == [x for _, x in b.accuracies]
              and a.executed_rounds == b.executed_rounds
              and a.times.actual == b.times.actual, f"{what}: trajectories")
        if b.final_residuals is not None:
            check(np.array_equal(a.final_residuals.view(np.uint32),
                                 b.final_residuals.view(np.uint32)),
                  f"{what}: EF residuals bit for bit")
        if b.overlap_hist is not None:
            check(np.array_equal(a.overlap_hist, b.overlap_hist),
                  f"{what}: Fig. 4 overlap histogram")

    for s in STRATEGIES:
        acfg = AggregationConfig(strategy=s)
        overlap = s == "bcrs_opwa"
        f1 = one(f"fused {s}", "fused", acfg, global_route, overlap)
        s1 = one(f"scan {s}", "scan", acfg, global_route, overlap)
        s2 = one(f"scan {s}", "scan", acfg, global_route, overlap)
        f2 = one(f"fused {s}", "fused", acfg, global_route, overlap)
        same(s1, f1, f"scan == fused {s}")
        same(s2, s1, f"scan run to run {s}")
        same(f2, f1, f"fused run to run {s}")
    eftopk = AggregationConfig(strategy="eftopk")
    # p = 0.6 leaves rounds of one or two live clients (padded slots)
    fail = dict(failure=FailureInjector(p_fail=0.6, seed=1))
    same(one("scan eftopk failures", "scan", eftopk, global_route, **fail),
         one("fused eftopk failures", "fused", eftopk, global_route, **fail),
         "scan == fused eftopk with failures")
    block = AggregationConfig(strategy="bcrs_opwa", block_topk=True)
    same(one("scan block bcrs_opwa", "scan", block, {"overlap_combine": 1}),
         one("fused block bcrs_opwa", "fused", block,
             {"overlap_combine": 1}),
         "scan == fused block bcrs_opwa")
    pop = one("pop_scan eftopk", "pop_scan", eftopk, global_route)
    check(pop.final_residuals.shape[0] == sim.n_clients,
          "pop_scan: per-client residuals [P, n]")
    one("run_fl_traced bcrs_opwa", "traced",
        AggregationConfig(strategy="bcrs_opwa"), global_route)

    # device activities under the profiler: every launch the counters saw
    # (warm-up rounds and replays) is a device activity, the radix select
    # three of them; per replay, one merge and three radix passes
    activities = {}
    for label, acfg, per_call in (
            ("scan bcrs_opwa", AggregationConfig(strategy="bcrs_opwa"),
             {"threshold_find": 3, "fused_merge": 1}),
            ("scan block bcrs_opwa", block, {"overlap_combine": 1})):
        def profiled():
            with torch_profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
                res = simmod.run_fl(sim, acfg, engine="scan", device="cuda")
                torch.cuda.synchronize()
            return res, prof
        (res, prof), counts = drive(kern, profiled)
        act = scan_kernel_activities(res, prof)
        check(act is not None, f"{label}: the profiler shows graph launches")
        replays = act["graph_launches"]
        check(replays == len(res.executed_rounds),
              f"{label}: {replays} graph launches")
        for name, per in per_call.items():
            check(counts[name] == replays + eng.WARMUP,
                  f"{label}: {counts[name]} {name} launches, expected one "
                  f"a replay and a warm-up round")
            check(act["activities"][name] == per * counts[name],
                  f"{label}: {act['activities'][name]} {name} device "
                  f"activities for {counts[name]} launches, expected {per} "
                  f"a launch")
        for name, n in counts.items():
            total[name] += n
        activities[label] = dict(act, launches={k: v for k, v in
                                                counts.items() if v})
        print(f"[scan profile] {label}: {json.dumps(activities[label])}")

    # a save/restore round trip of a scan's final model and residuals
    rng, clients, parts, fracs, (xtr, ytr, xte, yte), server = \
        simmod._setup_sim(sim, eftopk, "cuda")
    steps = simmod._steps_by_client(clients, sim)
    res = simmod._run_scan(sim, eftopk, rng, clients, parts, fracs,
                           server.links, server, steps, int(steps.max()),
                           xtr, ytr, xte, yte, None, None, False)
    tree = {"flat": server.flat, "residuals": server.residuals}
    with tempfile.TemporaryDirectory() as tmp:
        checkpointer.save(tmp, sim.rounds, tree,
                          extra={"accuracies": [list(a) for a in
                                                res.accuracies]})
        like = {k: torch.zeros_like(v) for k, v in tree.items()}
        got, step, extra = checkpointer.restore(tmp, like)
    check(step == sim.rounds and all(
        got[k].device == tree[k].device and bits_equal(got[k], tree[k])
        for k in tree), "checkpoint round trip of the scan's final state")
    acc = simmod.mlp_accuracy(server._unravel(got["flat"]),
                              torch.as_tensor(xte, device="cuda"),
                              torch.as_tensor(yte, device="cuda",
                                              dtype=torch.int64))
    check(acc == res.final_accuracy and extra["accuracies"][-1][1]
          == res.final_accuracy, "restored model gives the final accuracy")

    medians = {label: [r["wall_ms_per_round_median"] for r in rs]
               for label, rs in runs.items()}
    finals = {label: rs[0]["final_accuracy"] for label, rs in runs.items()}
    print(f"[scan] wall ms a round (medians, in run order): "
          f"{json.dumps(medians)}")
    print(f"[scan] final accuracy after {sim.rounds} rounds: "
          f"{json.dumps(finals)}")
    record["scan_phase"] = dict(rounds=sim.rounds, runs=runs,
                                activities_per_replay=activities,
                                checkpoint_round_trip=dict(
                                    step=step, final_accuracy=acc))
    return total


# ------------------------------------------------ population / async phase
#: the reference bench's dispatch shape (``benchmarks/bench_round.py
#: --async``: P = 64, K = 8, M = 32, 10 flushes, eftopk at cr 0.05, upload
#: failures p = 0.1) at the simulation MLP's full width
ASYNC_DISPATCH = dict(rounds=10, n_clients=64, participation=0.125,
                      batch_size=8, beta=5.0, n_train=2048, n_test=400,
                      eval_every=2, seed=3, async_buffer_k=8,
                      async_concurrency=32, async_p_fail_upload=0.1,
                      async_upload_timeout_s=600.0)
#: the bench's chaos case: heavy failures, 2 attempts, a tight timeout and
#: a stall deadline (partial flushes)
ASYNC_CHAOS = dict(rounds=12, n_clients=20, participation=0.25,
                   batch_size=16, beta=5.0, n_train=2000, n_test=500,
                   eval_every=1, seed=3, link_bw_sd_mbps=0.8,
                   async_p_fail_upload=0.6, async_max_attempts=2,
                   async_upload_timeout_s=120.0, async_stall_s=20.0)
POPULATIONS = (10 ** 3, 10 ** 6)
WAVE_WIDTHS = (1, 2, 4, 8, 16, 32)


def wave_width_probe(record):
    """Does a wave member's delta depend on the wave's width or on its slot?
    One member's batches at full width, trained in waves of each of
    ``WAVE_WIDTHS`` (the other rows live members with their own batches),
    at slot 0 and at the last slot; its delta's bits against the widest
    wave's. A measurement, not a check: the async engine trains every wave
    at one static width because of what this shows."""
    from repro_torch.fed import async_engine as ae
    from repro_torch.fed.simulation import FLSimConfig, mlp_init, mlp_loss
    sim = FLSimConfig()
    params = mlp_init(torch.Generator().manual_seed(0), sim.dim,
                      sim.n_classes, hidden=sim.hidden, device="cuda")
    n = sum(v.numel() for v in params.values())
    g = torch.Generator(device="cuda").manual_seed(5)
    wmax, steps, bs = max(WAVE_WIDTHS), 4, 8
    xs = torch.randn(wmax, steps, bs, sim.dim, device="cuda", generator=g)
    ys = torch.randint(0, sim.n_classes, (wmax, steps, bs), device="cuda",
                       generator=g)
    ring = 0.05 * torch.randn(1, n, device="cuda", generator=g)
    train = ae.make_wave_train_step(
        mlp_loss, params, lr=sim.lr,
        make_batches=lambda x: {"x": x["x"], "y": x["y"]})

    def member_delta(width, slot):
        order = [i for i in range(1, wmax)][: width - 1]
        order.insert(slot, 0)         # member 0 at ``slot``
        x = {"x": xs[order], "y": ys[order],
             "step_mask": torch.ones(width, steps, dtype=torch.bool,
                                     device="cuda"),
             "ver_idx": torch.zeros(width, dtype=torch.int64,
                                    device="cuda")}
        return train(ring, x)[slot]

    ref = member_delta(wmax, 0)
    out = {}
    for width in WAVE_WIDTHS:
        for slot in sorted({0, width - 1}):
            d = member_delta(width, slot)
            out[f"width {width} slot {slot}"] = dict(
                bit_equal=bits_equal(d, ref), max_abs_diff=max_abs(d, ref))
    record["wave_width_probe"] = out
    print(f"[async] a member's delta against the {wmax}-wide wave's, slot "
          f"0: {json.dumps(out)}")
    return out


def plain_route_check(popmod, cfg, acfg, kern, zero):
    """``run_population_rounds`` at P = 10^3 through the kernels against the
    same call on the plain route (``use_kernel=False``, same card, no kernel
    launched). One round: the residual store bit for bit (the EF residuals
    of both routes are exact; only the merge's client order differs), and
    the loss. Six rounds: comm time equal, the first loss bit for bit and
    every loss within 1e-3 relative (the merges' summation order moves the
    model by rounding from round 2 on). Launches are checked, and left out
    of the phase's totals: these runs compare the kernels with the plain
    route."""
    import dataclasses
    plain = dataclasses.replace(acfg, use_kernel=False)
    population = popmod.make_population(POPULATIONS[0], seed=0)
    one = dataclasses.replace(cfg, rounds=1)
    runs = {}
    for label, a, c in (("kernel 1", acfg, one), ("plain 1", plain, one),
                        ("kernel 6", acfg, cfg), ("plain 6", plain, cfg)):
        want = ({"threshold_find": c.rounds, "fused_merge": c.rounds}
                if a.use_kernel is not False else {})
        runs[label], counts = drive(kern, lambda: popmod.run_population_rounds(
            population, c, acfg=a, device="cuda"))
        check_counts(counts, dict(zero, **want),
                     f"run_population_rounds P={POPULATIONS[0]} {label}")
    (rk, _, sk), (rp, _, sp) = runs["kernel 1"], runs["plain 1"]
    rows = np.arange(POPULATIONS[0])
    same_rows = all(
        np.array_equal(a.view(np.uint32), b.view(np.uint32))
        for ids in np.array_split(rows, 10)
        for a, b in zip(sk.gather(ids), sp.gather(ids)))
    check(same_rows and rk.losses == rp.losses,
          "run_population_rounds P=1000, one round: residual store and loss "
          "bit for bit on the plain route")
    rk, rp = runs["kernel 6"][0], runs["plain 6"][0]
    rel = max(abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(rk.losses, rp.losses))
    check(rk.comm_actual_s == rp.comm_actual_s
          and rk.losses[0] == rp.losses[0] and rel <= 1e-3,
          f"run_population_rounds P=1000, six rounds: comm time, losses "
          f"(worst relative difference {rel}) against the plain route")
    max_flat = float(np.abs(rk.final_flat - rp.final_flat).max())
    print(f"[population] run_population_rounds P=1000 == plain route: one "
          f"round's store bit for bit; six rounds' losses within {rel:.3e} "
          f"relative, model within {max_flat:.3e}")
    return dict(losses_max_rel_diff=rel, final_flat_max_abs_diff=max_flat,
                plain_s_per_round=rp.wall_per_round)


def population_async_phase(kern, zero, record):
    """The population and async engines at the simulation MLP's full width,
    launches counted around each run: (a) ``run_fl(engine="population")``
    bit-equal to ``pop_scan`` (P = 10, 40 rounds, eftopk and qtopk);
    (b) ``run_population_rounds`` at P = 10^3 and 10^6 (cohort 16, 6
    rounds, eftopk at cr 0.1, a 16-chunk resident window spilling to a
    temporary directory), peak state bytes equal across P, and at P = 10^3
    against the same call on the plain route (no kernel launched): one
    round's residual store bit for bit, six rounds' comm time equal and
    losses within 1e-3 relative (the first bit for bit); (c) the async
    sync anchor bit-equal to ``scan`` (bcrs_opwa) and ``pop_scan``
    (eftopk); (d) the general loop at the bench's dispatch shape, batched
    bit-equal to sequential dispatch, and the bench's chaos case; (e) a
    crash at half the flushes (sparse store spilled) and a resume from the
    checkpoint, bit-equal to the uninterrupted run. Returns the launches
    summed over the runs, per kernel."""
    import tempfile
    from repro_torch.core.aggregation import AggregationConfig
    from repro_torch.fed import engine as eng
    from repro_torch.fed import population as popmod
    from repro_torch.fed.simulation import FLSimConfig, run_fl
    t_phase = time.perf_counter()
    sim = FLSimConfig()
    total = dict(zero)
    out = {}

    def counted(label, fn, want):
        res, counts = drive(kern, fn)
        check_counts(counts, dict(zero, **want), label)
        for name, v in counts.items():
            total[name] += v
        return res

    def merges(n):
        return {"threshold_find": n, "fused_merge": n}

    def same(a, b, what, residuals=True):
        check([x for _, x in a.accuracies] == [x for _, x in b.accuracies]
              and a.executed_rounds == b.executed_rounds
              and [t.actual for t in a.times.per_round]
              == [t.actual for t in b.times.per_round],
              f"{what}: accuracies, comm times, executed rounds")
        if residuals and b.final_residuals is not None:
            check(np.array_equal(a.final_residuals.view(np.uint32),
                                 b.final_residuals.view(np.uint32)),
                  f"{what}: final residuals bit for bit")

    def walls_ms(res):
        return [round(t * 1e3, 4) for t in res.wall_per_round]

    # (a) population == pop_scan, P = 10
    for s in ("eftopk", "qtopk"):
        acfg = AggregationConfig(strategy=s)
        pop = counted(f"population {s}", lambda: run_fl(
            sim, acfg, engine="population", device="cuda"),
            merges(sim.rounds))
        ref = counted(f"pop_scan {s}", lambda: run_fl(
            sim, acfg, engine="pop_scan", device="cuda"),
            merges(sim.rounds + eng.WARMUP))
        same(pop, ref, f"population == pop_scan {s}")
        check(bool(np.isfinite(pop.final_residuals).all())
              and pop.final_residuals.shape[0] == sim.n_clients
              and all(math.isfinite(v) for v in pop.losses),
              f"population {s}: finite [P, n] residuals and losses")
        out[f"population {s}"] = dict(
            wall_ms_per_round=walls_ms(pop),
            pop_scan_wall_ms_per_round=walls_ms(ref)[0],
            final_accuracy=pop.final_accuracy)
        print(f"[population] {s}: == pop_scan over {sim.rounds} rounds; "
              f"wall ms a round {walls_ms(pop)} (pop_scan replay "
              f"{walls_ms(ref)[0]}), final accuracy {pop.final_accuracy}")

    # (b) the streaming-cohort driver at P = 10^3 and 10^6
    cfg = popmod.PopulationRunConfig(cohort=16, rounds=6, dim=sim.dim,
                                     hidden=sim.hidden,
                                     n_classes=sim.n_classes)
    acfg = AggregationConfig(strategy="eftopk", cr=0.1)
    step, peaks = None, {}
    for p in POPULATIONS:
        population = popmod.make_population(p, seed=0)
        with tempfile.TemporaryDirectory() as spill:
            res, step, store = counted(
                f"run_population_rounds P={p}",
                lambda: popmod.run_population_rounds(
                    population, cfg, acfg=acfg, step=step, chunk_clients=1,
                    max_resident_chunks=16, spill_dir=spill, device="cuda"),
                merges(cfg.rounds))
        check(all(math.isfinite(v) for v in res.losses)
              and bool(np.isfinite(res.final_flat).all()),
              f"run_population_rounds P={p}: finite losses and model")
        check(store.chunk_spills > 0, f"P={p}: the window spilled")
        peaks[p] = res.peak_state_bytes
        out[f"run_population_rounds P={p}"] = dict(
            s_per_round=res.wall_per_round,
            gather_s=res.gather_seconds, scatter_s=res.scatter_seconds,
            peak_state_bytes=res.peak_state_bytes,
            chunk_spills=store.chunk_spills, losses=res.losses)
        print(f"[population] run_population_rounds P={p}: s a round "
              f"{res.wall_per_round}, gather {res.gather_seconds:.4f} s, "
              f"scatter {res.scatter_seconds:.4f} s, peak state "
              f"{res.peak_state_bytes} bytes, {store.chunk_spills} spills")
    check(len(set(peaks.values())) == 1,
          f"peak state bytes flat in P: {peaks}")
    out["run_population_rounds P=1000 plain route"] = plain_route_check(
        popmod, cfg, acfg, kern, zero)

    # (c) the async sync anchor == scan / pop_scan
    anchor = FLSimConfig(async_sync_arrivals=True)
    for s, ref_engine in (("bcrs_opwa", "scan"), ("eftopk", "pop_scan")):
        acfg = AggregationConfig(strategy=s)
        res = counted(f"async anchor {s}", lambda: run_fl(
            anchor, acfg, engine="async", device="cuda"),
            merges(sim.rounds))
        ref = counted(f"{ref_engine} {s}", lambda: run_fl(
            sim, acfg, engine=ref_engine, device="cuda"),
            merges(sim.rounds + eng.WARMUP))
        same(res, ref, f"async anchor == {ref_engine} {s}")
        out[f"async anchor {s}"] = dict(wall_ms_per_round=walls_ms(res),
                                        final_accuracy=res.final_accuracy)
        print(f"[async] sync anchor {s} == {ref_engine} over {sim.rounds} "
              f"rounds; wall ms a round {walls_ms(res)}")

    # (d) the general loop: a member's bits against its wave's width, then
    # batched dispatch against sequential at the bench's dispatch shape
    wave_width_probe(record)
    acfg = AggregationConfig(strategy="eftopk", cr=0.05)
    flushes = ASYNC_DISPATCH["rounds"]
    runs = {}
    for label, kw in (("batched", {}),
                      ("sequential", dict(async_batch_dispatch=False))):
        t0 = time.perf_counter()
        res = counted(f"async {label}", lambda: run_fl(
            FLSimConfig(**ASYNC_DISPATCH, **kw), acfg, engine="async",
            device="cuda"), merges(flushes))
        wall = time.perf_counter() - t0
        loop = res.async_loop
        runs[label] = res
        out[f"async {label}"] = dict(
            wall_s=wall, wall_ms_per_flush=walls_ms(res)[0],
            train_calls=loop.train_calls, train_rows=loop.train_rows,
            wave_sizes=loop.wave_sizes,
            wave_buckets_used=sorted(loop.wave_buckets_used),
            wave_width=loop.wave_width, forced_retires=loop.forced_retires,
            aborted_untrained=loop.aborted_untrained,
            peak_round_state_bytes=loop.peak_round_state_bytes,
            accuracies=res.accuracies)
        print(f"[async] {label} dispatch: {flushes} flushes, wall ms a "
              f"flush {walls_ms(res)[0]}, {loop.train_calls} train calls "
              f"for {loop.train_rows} updates (waves {loop.wave_sizes}, at "
              f"width {loop.wave_width}), accuracies {res.accuracies}")
    b, s = runs["batched"], runs["sequential"]
    same(b, s, "async batched == sequential")
    check(bits_equal(b.async_loop.flat, s.async_loop.flat)
          and [(t.actual, t.max, t.min) for t in b.times.per_round]
          == [(t.actual, t.max, t.min) for t in s.times.per_round],
          "async batched == sequential: params and virtual times")
    check(b.async_loop.train_calls < s.async_loop.train_calls,
          "batched dispatch trains in fewer calls")
    chaos = counted("async chaos", lambda: run_fl(
        FLSimConfig(**ASYNC_CHAOS), acfg, engine="async", device="cuda"),
        merges(ASYNC_CHAOS["rounds"]))
    durs = [t.actual for t in chaos.times.per_round]
    check(len(chaos.executed_rounds) == ASYNC_CHAOS["rounds"]
          and min(durs) >= 0.0, f"async chaos: completes, flush durations "
          f"{durs}")
    out["async chaos"] = dict(flush_durations_s=durs,
                              wall_ms_per_flush=walls_ms(chaos)[0],
                              accuracies=chaos.accuracies)
    print(f"[async] chaos: {len(durs)} flushes, virtual durations (s) "
          f"{[round(d, 3) for d in durs]}")

    # (e) crash at half the flushes and resume, the sparse store spilled
    with tempfile.TemporaryDirectory() as tmp:
        spilled = FLSimConfig(**ASYNC_DISPATCH, async_store_chunk=2,
                              async_store_resident=2,
                              async_store_spill=os.path.join(tmp, "spill"))
        full = counted("async uninterrupted", lambda: run_fl(
            spilled, acfg, engine="async", device="cuda"), merges(flushes))
        check(full.async_loop.store.chunk_spills > 0,
              "async: the sparse store spilled")
        ckpt = os.path.join(tmp, "ckpt")
        half = flushes // 2
        counted("async until the crash", lambda: run_fl(
            spilled, acfg, engine="async", device="cuda",
            checkpoint_dir=ckpt, checkpoint_every=2, stop_after=half),
            merges(half))
        resumed = counted("async resumed", lambda: run_fl(
            spilled, acfg, engine="async", device="cuda",
            checkpoint_dir=ckpt, checkpoint_every=2),
            merges(flushes - half // 2 * 2))
    same(resumed, full, "async restart == uninterrupted")
    check(bits_equal(resumed.async_loop.flat, full.async_loop.flat)
          and resumed.async_loop.proc.counter == full.async_loop.proc.counter,
          "async restart: params and dispatch counter")
    out["async restart"] = dict(crash_after=half,
                                resumed_from=half // 2 * 2)
    print(f"[async] crash after flush {half}, resumed from flush "
          f"{half // 2 * 2}: == uninterrupted")
    record["population_async_phase"] = dict(
        runs=out, seconds=time.perf_counter() - t_phase,
        launches={k: v for k, v in total.items() if v})
    print(f"[population/async phase] {time.perf_counter() - t_phase:.1f} s, "
          f"launches {record['population_async_phase']['launches']}")
    return total


# ------------------------------------------------ real-model FL training
#: stablelm-1.6b's largest leaves, one client's elements: the stacked MLP
#: matrix (w_up / w_gate, [24, 2048, 5632]) and the embedding / lm_head
#: ([100352, 2048])
N_WUP = 24 * 2048 * 5632
N_EMBED = 100352 * 2048
#: (label, C, n, EF, codec): the real-model merge's shapes, C * n > 2^31 at
#: C = 8; the CLI's bcrs_opwa at C = 8 and eftopk at C = 4 (int8 as qtopk)
BIG_LEAVES = (("w_up opwa", 8, N_WUP, False, "none"),
              ("embed opwa", 8, N_EMBED, False, "none"),
              ("w_up ef", 4, N_WUP, True, "none"),
              ("w_up ef int8", 4, N_WUP, True, "int8"))
FL_ROUNDS = 4                 # bcrs_opwa, the CLI defaults; the scan's
FL_EF_ROUNDS = 4              # eager round + 3 replays; eftopk at C = 4
FL_FAIL = 0.3                 # the run whose rounds hold masked slots
#: fl_train --population at full width: P registered clients, cohort 8
FL_POPULATION = 10_000
FL_POP_ROUNDS = 3
#: fl_train --engine async at full width: K = M = 4 with a ring of 2 was
#: reckoned above 70 GB (PERF.md), so K and M are halved
FL_ASYNC = dict(rounds=3, async_buffer_k=2, async_concurrency=2,
                async_version_ring=2)


#: the depth (layers) at which some earlier full-width paths run, at their
#: full width, so that the whole script stays near its 600 s aim: the FL
#: phase's eftopk C = 4 and fail-0.3 runs, the population run, the
#: recurrent families' f32 prefill-vs-decode check, and hymba's compressed
#: pods and ``fl_train`` (round engine and mesh scan). What they hold (EF
#: residuals, masked slots, the client store, the chunk carry, the merge
#: of every leaf, the scan bit-equal to the round engine) does not depend
#: on the depth. Since the layout phase joined the script, the centralised
#: training phase (stablelm), the recurrent training phase (hymba, rwkv6)
#: and the vlm's serving and training run cut too (the vlm at 2 of its 8
#: groups); the FL phase's leaf-shape twins, its full-width gradient and
#: async flush, the serve phases and whisper keep their full depth.
CUT_LAYERS = 8


def cut_config(cfg, n_layers: int):
    """``cfg`` with its first ``n_layers`` layers (and the global-attention
    layers among them); encdec's encoder cut to as many layers, vlm's
    groups to those of its first ``n_layers`` self layers (a whole number
    of groups)."""
    import dataclasses
    kw = dict(n_layers=n_layers, global_layers=tuple(
        g for g in cfg.global_layers if g < n_layers))
    if cfg.encdec is not None:
        kw["encdec"] = dataclasses.replace(
            cfg.encdec, n_enc_layers=min(n_layers, cfg.encdec.n_enc_layers))
    if cfg.vision is not None:
        per = cfg.n_layers // cfg.vision.n_cross_layers
        check(n_layers % per == 0, f"{cfg.name}: a cut of {n_layers} self "
              f"layers is a whole number of groups of {per}")
        kw["vision"] = dataclasses.replace(cfg.vision,
                                           n_cross_layers=n_layers // per)
    return dataclasses.replace(cfg, **kw)


@contextlib.contextmanager
def at_depth(n_layers):
    """``get_config`` as ``launch.fl_train``, ``launch.train`` and the
    checks' helpers read it, with ``n_layers`` layers (no change for
    None)."""
    import repro_torch.configs as configs
    from repro_torch.launch import fl_train as fl
    from repro_torch.launch import train as tr
    if n_layers is None:
        yield
        return
    full = configs.get_config

    def cut(arch):
        return cut_config(full(arch), n_layers)
    configs.get_config = fl.get_config = tr.get_config = cut
    try:
        yield
    finally:
        configs.get_config = fl.get_config = tr.get_config = full


def first_rows(tree, n: int):
    """The first ``n`` entries of every leaf's leading axis (views)."""
    if isinstance(tree, dict):
        return {k: first_rows(v, n) for k, v in tree.items()}
    return tree[:n]


def cut_model(model, params, n_layers):
    """The first ``n_layers`` layers of a stacked model (views), its
    encoder's first as many, or its first groups (vlm), and its config's
    model."""
    from repro_torch.models import Model
    cut = Model(cut_config(model.cfg, n_layers), device="cuda")
    out = dict(params)
    if "layers" in params:
        out["layers"] = first_rows(params["layers"], n_layers)
    if "encoder" in params:
        out["encoder"] = dict(params["encoder"], layers=first_rows(
            params["encoder"]["layers"], cut.cfg.encdec.n_enc_layers))
    if "groups" in params:
        out["groups"] = first_rows(params["groups"],
                                   cut.cfg.vision.n_cross_layers)
    return cut, out


def big_leaf_case(c: int, n: int, seed: int, ef: bool):
    """One real-model leaf's [C, n] updates (N(0, 1e-3), the scale of a
    bf16 delta) with the edges: a block of ties, a denormal row, a huge
    row; the path's k (cr 0.05) for client 0, n for client 1, a random k
    for the rest, and the last slot padded (inactive, all zero)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = 1e-3 * torch.randn(c, n, device="cuda", generator=g)
    e = 3e-4 * torch.randn(c, n, device="cuda", generator=g) if ef else None
    x[1, : n // 2] = x[1, 0]
    x[2] *= 1e-38
    x[-1] = 0.0
    if e is not None:
        e[-1] = 0.0
    ks = torch.randint(1, n + 1, (c,), device="cuda", generator=g,
                       dtype=torch.int32)
    ks[0] = round(0.05 * n)
    ks[1] = n
    w = torch.rand(c, device="cuda", generator=g) + 0.1
    w[-1] = 0.0
    w = (w / w.sum()).contiguous()
    active = torch.ones(c, device="cuda")
    active[-1] = 0.0
    return x, e, ks, w, active


def big_leaf_parity(tf, fm, record):
    """Both kernels against their twins, bitwise, at the real-model leaf
    shapes (C * n up to 2.2e9 > 2^31)."""
    from repro_torch.core.strategies import CODEC_LEVELS, quantization_scale
    worst = {"threshold_find": 0.0, "fused_merge": 0.0}
    out = {}
    for seed, (label, c, n, ef, codec) in enumerate(BIG_LEAVES):
        x, e, ks, w, active = big_leaf_case(c, n, 100 + seed, ef)
        th, am = tf.threshold_find(x, ks, e, emit_scale=True)
        tp, ap = tf.threshold_find_plain(x, ks, e, emit_scale=True)
        torch.cuda.synchronize()
        check(torch.equal(th, tp) and bits_equal(am, ap),
              f"threshold_find {label} C={c} n={n}")
        del tp, ap
        sc = (quantization_scale(am, CODEC_LEVELS[codec])
              if codec != "none" else None)
        kw = dict(opwa=not ef, gamma=3.0, d=1, codec=codec, scales=sc)
        got = fm.fused_merge(x, th, w, e, active, **kw)
        got = got if ef else (got,)
        want = fm.fused_merge_plain(x, th, w, e, active, **kw)
        want = want if ef else (want,)
        torch.cuda.synchronize()
        for g_, w_ in zip(got, want):
            check(bits_equal(g_, w_), f"fused_merge {label} C={c} n={n}")
            worst["fused_merge"] = max(worst["fused_merge"], max_abs(g_, w_))
        out[label] = dict(C=c, n=n, elements=c * n, ef=ef, codec=codec,
                          ks=ks.tolist(), thresholds=th.tolist())
        print(f"[fl parity] {label}: C={c} n={n} (C*n={c * n}) "
              f"threshold_find and fused_merge bitwise equal to their twins")
        del x, e, got, want, th, am
        torch.cuda.empty_cache()
    record["fl_big_leaf_parity"] = out
    return worst


def big_leaf_timings(tf, fm):
    """Kernel, twin and library times at the w_up leaf as the CLI's round
    gives it (C = 8, cr 0.05; OPWA, and EF at C = 4), beside the bounds."""
    rows = []
    for label, c, ef in (("w_up", 8, False), ("w_up ef", 4, True)):
        n = N_WUP
        g = torch.Generator(device="cuda").manual_seed(7)
        x = 1e-3 * torch.randn(c, n, device="cuda", generator=g)
        e = 3e-4 * torch.randn(c, n, device="cuda", generator=g) if ef \
            else None
        ks = torch.full((c,), round(0.05 * n), dtype=torch.int32,
                        device="cuda")
        w = torch.full((c,), 1.0 / c, device="cuda")
        th = tf.threshold_find(x, ks, e)
        elems = c * n
        tf_bytes = elems * 4 * (1 + int(ef)) + c * 4 * 2
        rows.append(timing_row(
            "threshold_find", label, "ef" if ef else "x only", tf_bytes,
            elems, time_ms(lambda: tf.threshold_find(x, ks, e), 5),
            time_ms(lambda: tf.threshold_find_plain(x, ks, e), 2, 1),
            "torch.kthvalue of the row bit patterns",
            None if ef else time_ms(lambda: torch.kthvalue(
                x.abs().view(torch.int32), n - int(ks[0]) + 1, dim=1), 2,
                1)))
        fm_bytes = elems * 4 * (1 + 2 * int(ef)) + n * 4 + c * 8
        rows.append(timing_row(
            "fused_merge", label, "ef (eftopk)" if ef else "opwa (bcrs_opwa)",
            fm_bytes, elems * (3 + 2 * int(ef)),
            time_ms(lambda: fm.fused_merge(x, th, w, e, opwa=not ef,
                                           gamma=3.0), 5),
            time_ms(lambda: fm.fused_merge_plain(x, th, w, e, opwa=not ef,
                                                 gamma=3.0), 2, 1),
            "none (no single PyTorch call computes it)", None))
        del x, e, th
        torch.cuda.empty_cache()
    return rows


def timed_merge(merge_leaf, events):
    """``compress_merge_leaf`` with a pair of CUDA events recorded around
    each call into ``events`` (the merge's share of a round)."""
    def timed(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = merge_leaf(*args, **kw)
        end.record()
        events.append((start, end))
        return out
    return timed


def bf16_ulp_close(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Within one bf16 ULP of the larger magnitude, elementwise."""
    a, b = a.float(), b.float()
    _, ex = torch.frexp(torch.maximum(a.abs(), b.abs()))
    return bool(((a - b).abs() <= torch.ldexp(torch.ones_like(a),
                                               ex - 8)).all())


def grad_reproducible(model, params, batch):
    """One client's loss and gradient at full width, twice on the same
    batch: bit for bit (the one-hot embedding's backward is a matmul). A
    leaf the loss does not read (rwkv6's ``final_norm_b``) gets zeros, as
    the trainers give it."""
    from repro_torch.dist.grad_sync import loss_and_grads
    outs = []
    for _ in range(2):
        loss, _, grads = loss_and_grads(model.loss_fn, params, batch)
        outs.append((loss, grads))
        del grads
    (l1, g1), (l2, g2) = outs
    same = bits_equal(l1, l2) and all(
        torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                    else a.view(torch.int32),
                    b.view(torch.int16) if b.dtype == torch.bfloat16
                    else b.view(torch.int32)) for a, b in zip(g1, g2))
    check(same, f"{model.cfg.name}: full-width gradient bit-reproducible "
          "run to run")
    return float(l1)


def routes_on_leaf(path, dl, res, w, ks, active, strat, gamma, overlap_d):
    """One leaf's ``[C, *leaf]`` updates through ``compress_merge_leaf`` by
    the kernel route and by the plain route: the kernel's thresholds bit
    for bit against ``threshold_find``'s twin, its masks against the plain
    bisection's, EF residuals bit for bit, agg within
    2*C*2^-24*gamma*sum|w v|. Returns (agg_k, agg_p, max |d agg|, the
    largest |d agg| over its bound)."""
    from repro_torch.core import compression as comp
    from repro_torch.fed import engine as eng
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import threshold_find as tf
    c = dl.shape[0]
    u2 = dl.float().reshape(c, -1)
    r2 = res.reshape(c, -1) if res is not None else None
    th = kops.topk_thresholds(u2, ks, residuals=r2)
    check(torch.equal(th, tf.threshold_find_plain(
        u2, ks.to(torch.int32), r2)), f"thresholds of {path}: the twin's")
    x2 = u2 + r2 if r2 is not None else u2
    del u2
    mask_p = comp.topk_compress_dynamic(x2, ks).mask
    mask_k = comp.magnitude_bits(x2) >= th[:, None]
    check(torch.equal(mask_k, mask_p), f"masks of {path}")
    del mask_p, th
    if active is not None:
        mask_k &= active[:, None]
    g = gamma if strat.overlap_weighted else 1.0
    wv = torch.zeros(x2.shape[1], dtype=torch.float64, device=x2.device)
    for ci in range(c):
        wv += (w[ci].double() * torch.where(
            mask_k[ci], x2[ci], torch.zeros_like(x2[ci])).double()).abs()
    del mask_k, x2
    bound = 2 * c * 2.0 ** -24 * g * wv
    del wv
    kw = dict(gamma=gamma, overlap_d=overlap_d,
              opwa=strat.overlap_weighted, residuals=res, active=active,
              value_codec=strat.value_codec,
              kernel_codec=strat.kernel_codec)
    agg_k, res_k = eng.compress_merge_leaf(dl, w, ks, use_kernel=True, **kw)
    agg_p, res_p = eng.compress_merge_leaf(dl, w, ks, use_kernel=False, **kw)
    if res is not None:
        check(bits_equal(res_k, res_p), f"EF residuals of {path}")
    del res_k, res_p
    diff = (agg_k.double() - agg_p.double()).abs().reshape(-1)
    check(bool((diff <= bound).all()), f"agg of {path} within the bound")
    out = (float(diff.max()),
           float((diff / bound.clamp_min(1e-300)).max()))
    del diff, bound
    return (agg_k, agg_p) + out


def routes_on_the_same_deltas(fl, cfg, params, residuals, record):
    """One round's deltas through both routes of ``compress_merge_leaf``,
    leaf by leaf (``routes_on_leaf``), ks bit for bit, and the new bf16
    params within one bf16 ULP."""
    from repro_torch.configs import get_config
    from repro_torch.core import compression as comp
    from repro_torch.core import cost_model
    from repro_torch.core.aggregation import AggregationConfig
    from repro_torch.core.strategies import get as get_strategy
    from repro_torch.fed import engine as eng
    from repro_torch.models import Model
    model = Model(get_config(cfg.arch), device="cuda")
    rng = np.random.default_rng(cfg.seed)
    links = cost_model.sample_links(cfg.clients, rng)
    n_flat = sum(p.numel() for _, p in eng.tree_items(params))
    plan = fl._build_plan(cfg, rng, np.full(cfg.clients, 1 / cfg.clients),
                          links, 4.0 * n_flat,
                          AggregationConfig(strategy=cfg.strategy,
                                            cr=cfg.cr), None, None)
    batches = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
               for k, v in fl._round_batches(cfg, model.cfg.vocab_size, 0,
                                             cfg.c_slots).items()}
    strat = get_strategy(cfg.strategy)
    train = eng.make_model_local_trainer(model.loss_fn, cfg.lr)
    deltas, _ = train(params, batches, torch.from_numpy(plan.step_mask[0]))
    w = torch.from_numpy(plan.weights[0]).cuda()
    crs = torch.from_numpy(plan.crs[0]).cuda()
    active = torch.from_numpy(plan.active[0]).cuda()
    d_items = eng.tree_items(deltas)
    r_items = (eng.tree_items(residuals) if strat.needs_residuals
               else [(k, None) for k, _ in d_items])
    del deltas
    worst_agg, worst_ratio, leaves = 0.0, 0.0, 0
    for i, ((path, p), (_, res)) in enumerate(
            zip(eng.tree_items(params), r_items)):
        dl = d_items[i][1]
        d_items[i] = None
        n = dl[0].numel()
        ks = comp.k_for_ratio_traced(n, crs)
        # the rule both routes share: round(cr * n) in f32, half to even,
        # clipped to [1, n]
        want_ks = np.clip(np.round(plan.crs[0] * np.float32(n)), 1, n)
        check(np.array_equal(ks.cpu().numpy(), want_ks.astype(np.int32)),
              f"ks of {path}")
        agg_k, agg_p, d_max, ratio = routes_on_leaf(
            path, dl, res, w, ks, active, strat, cfg.gamma, cfg.overlap_d)
        del dl
        worst_agg = max(worst_agg, d_max)
        worst_ratio = max(worst_ratio, ratio)
        pk = (p.float() - cfg.eta * agg_k).to(p.dtype)
        pp = (p.float() - cfg.eta * agg_p).to(p.dtype)
        check(bf16_ulp_close(pk, pp) if p.dtype == torch.bfloat16
              else float((pk - pp).abs().max()) <= 2.0 ** -22 * float(
                  pk.abs().max()),
              f"new params of {path}: kernel and plain route")
        del agg_k, agg_p, pk, pp
        torch.cuda.empty_cache()
        leaves += 1
    out = dict(strategy=cfg.strategy, clients=cfg.clients, leaves=leaves,
               max_abs_agg_diff=worst_agg, max_agg_diff_over_bound=worst_ratio)
    record.setdefault("fl_routes", []).append(out)
    print(f"[fl routes] {cfg.strategy} C={cfg.clients}: {leaves} leaves, "
          f"masks, ks and residuals bitwise; agg max |d| {worst_agg:.3g} "
          f"({worst_ratio:.3g} of its bound); new params within 1 bf16 ULP")


def host_copy(tree):
    """A (nested) dict of device tensors -> the same on the host."""
    from repro_torch.fed import engine as eng
    return eng.tree_from_items((k, v.cpu()) for k, v in eng.tree_items(tree))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, any float dtype (both on the host)."""
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    return a.dtype == b.dtype and torch.equal(a.view(view[a.dtype]),
                                              b.view(view[b.dtype]))


def trees_same_bits(dev_tree, host_tree) -> bool:
    """A device tree against a host copy, leaf by leaf (one leaf on the
    host at a time)."""
    from repro_torch.fed import engine as eng
    return all(same_bits(a.cpu(), b) for (_, a), (_, b) in zip(
        eng.tree_items(dev_tree), eng.tree_items(host_tree)))


def masked_slots(fl, cfg, n_flat):
    """The plan's inactive (slot, round) pairs per executed round, from the
    same host plan ``fl_train.run`` builds."""
    from repro_torch.core import cost_model
    from repro_torch.core.aggregation import AggregationConfig
    from repro_torch.ft import FailureInjector, StragglerPolicy
    rng = np.random.default_rng(cfg.seed)
    links = cost_model.sample_links(cfg.clients, rng)
    plan = fl._build_plan(
        cfg, rng, np.full(cfg.clients, 1 / cfg.clients), links,
        4.0 * n_flat, AggregationConfig(strategy=cfg.strategy, cr=cfg.cr),
        FailureInjector(p_fail=cfg.fail_prob, seed=cfg.seed)
        if cfg.fail_prob > 0 else None,
        StragglerPolicy(over_selection=cfg.over_selection)
        if cfg.over_selection > 0 else None)
    return [int((~a).sum()) for a in plan.active]


def scan_against_round(kern, zero, fl, cfg, ref, leaves, n_params, label):
    """``fl_train.run(engine="scan")`` on ``cfg`` against the round
    engine's run of it (``ref``: losses, and params / residuals as host
    copies), with the counts reset just before and read just after: one
    capture, each kernel launched ``leaves`` times a replay and
    ``leaves`` x rounds in all (the eager first round's included),
    params, residuals and losses bit for bit; replay wall a round, eager
    round, capture seconds and peak memory."""
    import dataclasses
    import gc
    from repro_torch.fed import engine as eng
    scfg = dataclasses.replace(cfg, engine="scan")
    key = ("mesh_scan", cfg.strategy)
    before = eng.TRACE_COUNTS[key]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res, counts = drive(kern, lambda: fl.run(scfg))
    peak = torch.cuda.max_memory_allocated()
    n = len(res["executed_rounds"])
    st = res["scan"]
    check(n == cfg.rounds and res["chunk_rounds"] == [n],
          f"scan {label}: rounds executed in one chunk")
    check(eng.TRACE_COUNTS[key] - before == 1,
          f"scan {label}: one capture a run")
    check(st["launches_per_replay"] == {"threshold_find": leaves,
                                        "fused_merge": leaves},
          f"scan {label}: launches a replay {st['launches_per_replay']}")
    check_counts(counts, dict(zero, threshold_find=leaves * n,
                              fused_merge=leaves * n), f"scan {label}")
    check(res["executed_rounds"] == ref["executed_rounds"]
          and res["losses"] == ref["losses"],
          f"scan {label}: losses bit for bit {res['losses']} vs "
          f"{ref['losses']}")
    check(trees_same_bits(res["params"], ref["params"]),
          f"scan {label}: params bit for bit")
    if ref["residuals"] is not None:
        check(trees_same_bits(res["residuals"], ref["residuals"]),
              f"scan {label}: EF residuals bit for bit")
    walls = res["wall_per_round"]
    replay_s = walls[1]
    check(walls == [st["eager_round_s"]] + [replay_s] * (n - 1),
          f"scan {label}: wall_per_round the eager round's, then the "
          f"replays' {res['wall_per_round']}")
    out = dict(strategy=cfg.strategy, clients=cfg.clients,
               fail_prob=cfg.fail_prob, rounds=n, parameters=n_params,
               losses=res["losses"], eager_round_s=st["eager_round_s"],
               replay_s_per_round=replay_s, capture_s=st["capture_s"],
               wall_per_round_s=res["wall_per_round"],
               peak_memory_bytes=peak, launches=counts,
               launches_per_replay=st["launches_per_replay"],
               bitwise_vs_round_engine=["params", "losses"]
               + (["residuals"] if ref["residuals"] is not None else []))
    print(f"[fl scan] {label}: {n} rounds == the round engine bit for bit "
          f"({', '.join(out['bitwise_vs_round_engine'])}); eager round "
          f"{st['eager_round_s']:.3f} s, replay {replay_s:.4f} s a round, "
          f"capture {st['capture_s']:.2f} s; peak {peak / 1e9:.2f} GB; "
          f"launches {counts['threshold_find']} + {counts['fused_merge']}"
          f" (a replay {st['launches_per_replay']})")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return out, counts


def profile_scan_replay(fl, cfg, record):
    """Two replays of the full-width scan round (bcrs_opwa, C = 8, the
    plan's rounds 0 and 1) under ``torch.profiler``, after its eager round
    and capture: device time by kernel and the idle share."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.core import cost_model
    from repro_torch.core.aggregation import AggregationConfig
    from repro_torch.fed import engine as eng
    from repro_torch.models import Model
    model = Model(get_config(cfg.arch), device="cuda")
    params = model.init(cfg.seed)
    n_flat = sum(p.numel() for _, p in eng.tree_items(params))
    rng = np.random.default_rng(cfg.seed)
    links = cost_model.sample_links(cfg.clients, rng)
    plan = fl._build_plan(cfg, rng, np.full(cfg.clients, 1 / cfg.clients),
                          links, 4.0 * n_flat,
                          AggregationConfig(strategy=cfg.strategy,
                                            cr=cfg.cr), None, None)
    idx = [0, 1]
    xs = {"batches": fl._stack_batches(cfg, model.cfg.vocab_size, idx,
                                       cfg.c_slots),
          "step_mask": plan.step_mask[idx], "active": plan.active[idx],
          "weights": plan.weights[idx], "crs": plan.crs[idx]}
    sim = eng.make_mesh_sim_scan(model.loss_fn, params, lr=cfg.lr,
                                 strategy=cfg.strategy, eta=cfg.eta,
                                 gamma=cfg.gamma, overlap_d=cfg.overlap_d)
    program = sim.compile(params, torch.zeros((0,), device="cuda"), xs)
    program()                     # the eager round, the capture, a replay
    torch.cuda.synchronize()
    _, wall, by_name = device_profile(program)        # two replays
    out = busy_record(wall, by_name)
    out.update(replays=2, wall_ms_per_replay=wall / 2,
               device_busy_ms_per_replay=(
                   sum(ms for ms, _ in by_name.values()) / 2 if by_name
                   else "not measured"))
    record["profile_fl_scan_replay"] = out
    print("[profile fl scan replay]", json.dumps(out))
    del program, sim, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def recording_first_flush(n_flat: int):
    """Context: ``kernels.ops``' ``threshold_find`` and ``fused_merge``
    (the async merge's route) wrapped so that the first call of each on
    rows of the whole raveled model (``[K, n_flat]``) keeps host copies of
    its inputs and outputs in the dict it yields (``copy_s``: the host
    wall those copies took). The wrapped kernels still launch, and count,
    once a call."""
    import contextlib
    from repro_torch.kernels import ops as kops

    def host(t):
        return None if t is None else t.detach().cpu()

    rec = {"copy_s": 0.0}
    tf_k, fm_k = kops.threshold_find, kops.fused_merge

    def tf_rec(x, ks, e=None, emit_scale=False):
        out = tf_k(x, ks, e, emit_scale=emit_scale)
        if "th" not in rec and x.shape[1] == n_flat:
            t0 = time.perf_counter()
            rec.update(x=host(x), ks=host(ks), e=host(e),
                       emit_scale=emit_scale,
                       th=host(out[0] if emit_scale else out),
                       absmax=host(out[1]) if emit_scale else None)
            rec["copy_s"] += time.perf_counter() - t0
        return out

    def fm_rec(x, thresholds, weights, e=None, active=None, **kw):
        out = fm_k(x, thresholds, weights, e, active, **kw)
        if "agg" not in rec and x.shape[1] == n_flat:
            t0 = time.perf_counter()
            rec.update(weights=host(weights), active=host(active), kw=kw,
                       agg=host(out if e is None else out[0]),
                       new_res=None if e is None else host(out[1]))
            rec["copy_s"] += time.perf_counter() - t0
        return out

    @contextlib.contextmanager
    def recording():
        kops.threshold_find, kops.fused_merge = tf_rec, fm_rec
        try:
            yield rec
        finally:
            kops.threshold_find, kops.fused_merge = tf_k, fm_k

    return recording()


def flush_against_twins(rec):
    """The async run's first flush as recorded by ``recording_first_flush``
    (the run's buffers freed), through both kernels' twins on the card:
    thresholds (and absmax), agg and new residuals bit for bit."""
    from repro_torch.kernels import fused_merge as fm
    from repro_torch.kernels import threshold_find as tf
    check("th" in rec and "agg" in rec, "async: the first flush recorded")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    x = rec["x"].cuda()
    e = rec["e"].cuda() if rec["e"] is not None else None
    ks = rec["ks"].cuda()
    th = rec["th"].cuda()
    want = tf.threshold_find_plain(x, ks, e, emit_scale=rec["emit_scale"])
    torch.cuda.synchronize()
    if rec["emit_scale"]:
        check(bits_equal(want[1].cpu(), rec["absmax"]),
              "async flush 0: threshold_find absmax against its twin")
        want = want[0]
    check(torch.equal(want, th),
          "async flush 0: threshold_find against its twin")
    del want
    torch.cuda.empty_cache()
    act = rec["active"].cuda() if rec["active"] is not None else None
    want = fm.fused_merge_plain(x, th, rec["weights"].cuda(), e, act,
                                **rec["kw"])
    if e is not None:
        want, new_res = want
        del x, e
        check(bits_equal(new_res.cpu(), rec["new_res"]),
              "async flush 0: fused_merge residuals against its twin")
        del new_res
    else:
        del x
    torch.cuda.empty_cache()
    check(bits_equal(want, rec["agg"].cuda()),
          "async flush 0: fused_merge agg against its twin")
    del want
    torch.cuda.empty_cache()
    c, n = rec["x"].shape
    check_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    print(f"[fl async] the first flush's merge at [K={c}, n={n}] (C*n="
          f"{c * n}): threshold_find and fused_merge bitwise equal to "
          f"their twins on the same inputs ({check_s:.2f} s, peak "
          f"{peak / 1e9:.2f} GB)")
    return dict(C=c, n=n, elements=c * n, ks=rec["ks"].tolist(),
                thresholds=rec["th"].tolist(), host_copy_s=rec["copy_s"],
                check_s=check_s, check_peak_memory_bytes=peak,
                bitwise=["thresholds", "agg"]
                + (["residuals"] if rec["e"] is not None else []))


def fl_engines_at_full_width(kern, zero, fl, leaves, n_params, record):
    """``fl_train --population`` (bcrs_opwa, P = 10,000, cohort 8, no
    store) and ``--engine async`` (bcrs_opwa, ``FL_ASYNC``) at full width,
    each with the counts reset just before and read just after: finite
    losses / params, launches (leaves x rounds; one of each kernel a
    flush), wall, peak memory. The async merge takes the whole raveled
    model as one [K, n] row block: its first flush's kernel inputs and
    outputs are kept on the host and, the run's buffers freed, held
    against the twins at that shape (``flush_against_twins``)."""
    import contextlib
    import gc
    from repro_torch.fed import engine as eng
    out, total = {}, dict(zero)
    for label, kw, want in (
            ("population", dict(population=FL_POPULATION, cohort=8,
                                rounds=FL_POP_ROUNDS),
             leaves * FL_POP_ROUNDS),
            ("async", dict(engine="async", **FL_ASYNC), FL_ASYNC["rounds"])):
        cfg = fl.FLTrainConfig(device="cuda", **kw)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        recorder = (recording_first_flush(n_params) if label == "async"
                    else contextlib.nullcontext({}))
        depth = CUT_LAYERS if label == "population" else None
        t0 = time.perf_counter()
        with recorder as rec, at_depth(depth):
            res, counts = drive(kern, lambda: fl.run(cfg))
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        check(len(res["executed_rounds"]) == kw["rounds"],
              f"fl {label}: rounds / flushes executed")
        check(all(math.isfinite(v) for v in res["losses"]),
              f"fl {label}: finite losses")
        check(all(bool(torch.isfinite(p).all())
                  for _, p in eng.tree_items(res["params"])),
              f"fl {label}: finite params")
        check_counts(counts, dict(zero, threshold_find=want,
                                  fused_merge=want), f"fl {label}")
        for name, n in counts.items():
            total[name] += n
        run_rec = dict(config={k: v for k, v in kw.items()},
                       n_layers=depth or "full", strategy=cfg.strategy,
                       losses=res["losses"],
                       wall_per_round_s=res["wall_per_round"],
                       run_wall_s=wall, peak_memory_bytes=peak,
                       launches=counts)
        if label == "async":
            loop = res["async_loop"]
            run_rec.update(
                host_copy_s=rec["copy_s"], train_calls=loop.train_calls,
                client_updates=loop.train_rows, wave_sizes=loop.wave_sizes,
                forced_retires=loop.forced_retires,
                peak_round_state_bytes=loop.peak_round_state_bytes)
            del loop
        out[label] = run_rec
        print(f"[fl {label}] full width: {json.dumps(run_rec)}")
        del res
        gc.collect()
        torch.cuda.empty_cache()
        if label == "async":
            run_rec["first_flush_against_twins"] = flush_against_twins(rec)
            del rec
            gc.collect()
    record["fl_engines_full_width"] = out
    return total


def fl_restarts_reduced(fl):
    """``--population`` (eftopk over a sparse store, P = 24, cohort 3) and
    ``--engine async`` (eftopk over a sparse store, P = 10) at ``reduced()``
    size: a crash and resume equal to the uninterrupted run bit for bit,
    every client's residual included."""
    import tempfile
    from repro_torch.fed import engine as eng
    base = dict(device="cuda", reduced=True, local_steps=1, batch=2,
                seq=16, seed=0, verbose=False, strategy="eftopk")
    cases = (("population", dict(clients=2, population=24, cohort=3,
                                 fail_prob=0.25, checkpoint_every=2),
              4, 2),
             ("async", dict(engine="async", clients=6, population=10,
                            cohort=2, async_buffer_k=2,
                            async_concurrency=3, async_version_ring=2,
                            checkpoint_every=1), 4, 2))
    for label, kw, rounds, cut in cases:
        with tempfile.TemporaryDirectory() as tmp:
            full = fl.run(fl.FLTrainConfig(
                rounds=rounds, checkpoint_dir=os.path.join(tmp, "a"),
                **base, **kw))
            d = os.path.join(tmp, "b")
            fl.run(fl.FLTrainConfig(rounds=cut, checkpoint_dir=d, **base,
                                    **kw))
            resumed = fl.run(fl.FLTrainConfig(rounds=rounds,
                                              checkpoint_dir=d, **base,
                                              **kw))
        check(all(bits_equal(a, b) for (_, a), (_, b) in zip(
            eng.tree_items(full["params"]),
            eng.tree_items(resumed["params"]))),
            f"fl {label} restart: params bit for bit")
        check(full["losses"][cut:] == resumed["losses"],
              f"fl {label} restart: losses")
        store = full["residuals"]
        dense = store.dump_dense()
        check(dense.any() and np.array_equal(
            dense.view(np.uint32),
            resumed["residuals"].dump_dense().view(np.uint32)),
            f"fl {label} restart: every client's residual bit for bit")
        print(f"[fl {label}] restart at reduced() size (eftopk, sparse "
              f"store): {cut} rounds, then resume to {rounds} == "
              f"{rounds} rounds bit for bit, store included")


def fl_round_run(kern, zero, fl, cfg, leaves, label):
    """``fl_train.run`` on ``cfg`` (the round engine) with the counts set
    to 0 just before and read just after: the rounds run, finite losses,
    each kernel launched leaves x rounds, wall per round (first apart),
    peak memory and the merge's share of a round from CUDA events around
    each leaf's ``compress_merge_leaf``. Returns (its record, the run's
    result, counts)."""
    from repro_torch.fed import mesh_round
    torch.cuda.reset_peak_memory_stats()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    events = []
    merge_leaf = mesh_round.compress_merge_leaf
    mesh_round.compress_merge_leaf = timed_merge(merge_leaf, events)
    try:
        res, counts = drive(kern, lambda: fl.run(cfg))
    finally:
        mesh_round.compress_merge_leaf = merge_leaf
    n_rounds = len(res["executed_rounds"])
    check(n_rounds == cfg.rounds, f"{label}: rounds executed")
    check(all(math.isfinite(v) for v in res["losses"]),
          f"{label}: finite losses {res['losses']}")
    check_counts(counts, dict(zero, threshold_find=leaves * n_rounds,
                              fused_merge=leaves * n_rounds), label)
    check(len(events) == leaves * n_rounds, f"{label}: merge events")
    merge_ms = [sum(s.elapsed_time(e) for s, e in
                    events[r * leaves:(r + 1) * leaves])
                for r in range(n_rounds)]
    wall = res["wall_per_round"]
    peak = torch.cuda.max_memory_allocated()
    rec = dict(
        arch=cfg.arch, strategy=cfg.strategy, clients=cfg.clients,
        fail_prob=cfg.fail_prob, rounds=n_rounds, losses=res["losses"],
        wall_per_round_s=wall, first_round_s=wall[0],
        later_rounds_s=wall[1:], merge_ms_per_round=merge_ms,
        merge_share=[m / 1e3 / t for m, t in zip(merge_ms, wall)],
        peak_memory_bytes=peak, launches=counts,
        alloc_retries=torch.cuda.memory_stats().get("num_alloc_retries", 0)
        - retries)
    print(f"[fl] {label}: losses {res['losses']} wall per round (s) "
          f"first {wall[0]:.3f}, then {[round(t, 4) for t in wall[1:]]}"
          f"; merge {[round(m, 2) for m in merge_ms]} ms a round "
          f"(share {[round(s, 4) for s in rec['merge_share']]})"
          f"; peak memory {peak / 1e9:.2f} GB ({rec['alloc_retries']} "
          f"allocator retries); launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    return rec, res, counts


def fl_train_phase(kern, zero, record):
    """Real-model FL training at stablelm-1.6b's full width on the card:
    (a) ``threshold_find`` and ``fused_merge`` bit for bit against their
    twins at the real leaf shapes (``BIG_LEAVES``: C * n up to 2.2e9) and
    timed at the w_up leaf; (b) one client's full-width gradient twice,
    bit for bit; ``fl_train.run(engine="round")`` at the CLI's defaults
    (bcrs_opwa, C = 8, 4 rounds), eftopk at C = 4 (its f32 residuals do
    not fit at C = 8) and bcrs_opwa with ``fail_prob`` 0.3, each with the
    counts reset just before and read just after: finite losses, each
    kernel launched leaves x rounds, wall per round (first apart), peak
    memory, the merge's share of a round from CUDA events around each
    leaf's ``compress_merge_leaf``; (c) after the eftopk run, one round's
    deltas from its trained state through both routes of
    ``compress_merge_leaf`` (``routes_on_the_same_deltas``); (d) each run
    again through the mesh scan (``scan_against_round``), two replays
    profiled (``profile_scan_replay``); (e) ``--population`` and
    ``--engine async`` at full width (``fl_engines_at_full_width``); (f)
    restarts at ``reduced()`` depth and width: the round engine (eftopk, 3
    rounds then resume to 6), population and async
    (``fl_restarts_reduced``), each equal to the uninterrupted run bit for
    bit. Returns (launches per kernel over the full-width runs, the
    kernels' worst twin differences, timing rows)."""
    import gc
    import tempfile
    from repro_torch.fed import engine as eng
    from repro_torch.kernels import fused_merge as fm
    from repro_torch.kernels import threshold_find as tf
    from repro_torch.configs import get_config
    from repro_torch.launch import fl_train as fl
    from repro_torch.models import Model
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    worst = big_leaf_parity(tf, fm, record)
    rows = big_leaf_timings(tf, fm)
    for row in rows:
        print("[timing]", json.dumps(row))

    cfg0 = fl.FLTrainConfig(engine="round", device="cuda")
    model = Model(get_config(cfg0.arch), device="cuda")
    params = model.init(cfg0.seed)
    toks = fl._round_batches(cfg0, model.cfg.vocab_size, 0, 1)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[0, 0])).cuda()
             for k, v in toks.items()}
    loss0 = grad_reproducible(model, params, batch)
    leaves = len(eng.tree_items(params))
    n_params = sum(p.numel() for _, p in eng.tree_items(params))
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[fl] stablelm-1.6b: {n_params} parameters in {leaves} leaves; "
          f"one client's loss {loss0:.4f}, its gradient bit-reproducible")

    total = dict(zero)
    runs, scans = {}, {}
    for label, kw in (("bcrs_opwa C=8", dict(rounds=FL_ROUNDS)),
                      ("eftopk C=4", dict(rounds=FL_EF_ROUNDS,
                                          strategy="eftopk", clients=4)),
                      (f"bcrs_opwa C=8 fail {FL_FAIL}",
                       dict(rounds=FL_ROUNDS, fail_prob=FL_FAIL))):
        cfg = fl.FLTrainConfig(engine="round", device="cuda", **kw)
        depth = CUT_LAYERS
        with at_depth(depth):
            runs[label], res, counts = fl_round_run(kern, zero, fl, cfg,
                                                    leaves, label)
            runs[label]["n_layers"] = depth or model.cfg.n_layers
            for name, n in counts.items():
                total[name] += n
            wall = res["wall_per_round"]
            params, residuals = res["params"], res["residuals"]
            n_run = sum(p.numel() for _, p in eng.tree_items(params))
            ref = dict(executed_rounds=res["executed_rounds"],
                       losses=res["losses"], params=host_copy(params),
                       residuals=(host_copy(residuals)
                                  if cfg.strategy == "eftopk" else None))
            del res
            gc.collect()
            torch.cuda.empty_cache()
            if cfg.strategy == "eftopk":
                # one round's deltas through both routes (EF: masks, ks,
                # residuals, agg and params all compared)
                routes_on_the_same_deltas(fl, cfg, params, residuals,
                                          record)
            del params, residuals
            gc.collect()
            torch.cuda.empty_cache()
            # the same run through the mesh scan: one CUDA graph a round
            scans[label], counts = scan_against_round(
                kern, zero, fl, cfg, ref, leaves, n_run, label)
            for name, n in counts.items():
                total[name] += n
            scans[label]["round_engine_later_rounds_s"] = wall[1:]
            scans[label]["masked_slots_per_round"] = masked_slots(fl, cfg,
                                                                  n_run)
        del ref
        gc.collect()

    # two replays under the profiler, and what the masked slots cost: the
    # replay trains every slot, so a masked slot costs its share of the
    # replay's device time outside the merge
    with at_depth(CUT_LAYERS):
        prof = profile_scan_replay(fl, fl.FLTrainConfig(engine="scan",
                                                        device="cuda"),
                                   record)
    busy = prof["device_busy_ms_per_replay"]
    fail = scans[f"bcrs_opwa C=8 fail {FL_FAIL}"]
    if busy != "not measured":
        merge = sum(runs["bcrs_opwa C=8"]["merge_ms_per_round"][1:]) / (
            FL_ROUNDS - 1)
        per_slot = (busy - merge) / 8
        fail["masked_slot_device_ms_estimate"] = per_slot
        fail["masked_device_ms_per_round"] = [
            m * per_slot for m in fail["masked_slots_per_round"]]
    print(f"[fl scan] fail {FL_FAIL}: masked slots a round "
          f"{fail['masked_slots_per_round']}, device ms they cost a round "
          f"{fail.get('masked_device_ms_per_round', 'not measured')}")
    check(any(fail["masked_slots_per_round"][1:]),
          "the fail run's replayed rounds hold masked slots")

    for name, n in fl_engines_at_full_width(kern, zero, fl, leaves,
                                            n_params, record).items():
        total[name] += n
    fl_restarts_reduced(fl)

    # the restart check at reduced depth and width, to keep the checkpoint
    # bytes small
    kw = dict(engine="round", device="cuda", reduced=True, strategy="eftopk",
              fail_prob=0.2, checkpoint_every=2, verbose=False)
    full = fl.run(fl.FLTrainConfig(rounds=6, **kw))
    with tempfile.TemporaryDirectory() as tmp:
        part = fl.run(fl.FLTrainConfig(rounds=3, checkpoint_dir=tmp, **kw))
        resumed = fl.run(fl.FLTrainConfig(rounds=6, checkpoint_dir=tmp,
                                          **kw))
    check(resumed["resumed_from"] == 3
          and part["executed_rounds"] + resumed["executed_rounds"]
          == full["executed_rounds"], "fl restart: rounds")
    for key in ("params", "residuals"):
        check(all(bits_equal(a.float(), b.float()) for (_, a), (_, b) in zip(
            eng.tree_items(full[key]), eng.tree_items(resumed[key]))),
            f"fl restart: {key} bit for bit")
    check(part["losses"] + resumed["losses"] == full["losses"],
          "fl restart: losses")
    print("[fl] restart at reduced() depth and width (2 layers, d_model "
          "64, eftopk, 3 rounds then resume to 6) == 6 rounds bit for bit")
    record["fl_train_phase"] = dict(
        model="stablelm-1.6b", parameters=n_params, leaves=leaves,
        runs=runs, scans=scans, seconds=time.perf_counter() - t_phase,
        launches={k: v for k, v in total.items() if v},
        restart="reduced() depth and width, bit for bit")
    print(f"[fl phase] {time.perf_counter() - t_phase:.1f} s, launches "
          f"{record['fl_train_phase']['launches']}")
    return total, worst, rows


# ------------------------------------------------ centralised training
TRAIN_STEPS = 4               # the CLI's defaults otherwise: B = 8, S = 256
TRAIN_PODS = 4                # --compressed-pods 4 --wire-cr 0.05
TRAIN_ADAMW_PODS = 2          # compressed adamw at 4 pods would not fit
TRAIN_MIN_LEAF = 4096         # make_compressed_train_step's min_leaf_size


def ulp_of(x: torch.Tensor) -> torch.Tensor:
    """One ulp of |x| in x's dtype (bf16: 8 significant bits; f32: 24; at
    0, the smallest normal's)."""
    _, ex = torch.frexp(x.float().abs().clamp_min(torch.finfo(x.dtype).tiny))
    bits = 8 if x.dtype == torch.bfloat16 else 24
    return torch.ldexp(torch.ones_like(ex, dtype=torch.float64),
                       ex.to(torch.float64) - bits)


def tree_bits_equal(a, b) -> bool:
    """Two trees of tensors, leaf for leaf and bit for bit (ints equal)."""
    from repro_torch.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and (same_bits(x.cpu(), y.cpu())
                                if x.is_floating_point()
                                else torch.equal(x.cpu(), y.cpu()))
        for x, y in zip(la, lb))


def check_ef(label, ef, embed_kept_whole: bool):
    """EF residuals after compressed steps: exactly 0 on the leaves below
    ``TRAIN_MIN_LEAF`` (exchanged dense), nonzero on the compressed ones.
    The embedding table's gradient is nonzero only on the rows of the
    tokens a pod sees (at most 512 x 2048 = 1,048,576 elements, below
    every k = cr * 205,520,896 >= 5,138,022), so Top-K keeps all of it and,
    without a codec, its residual stays exactly 0 (``embed_kept_whole``);
    a codec's quantization error makes it nonzero."""
    from repro_torch.fed import engine as eng
    for path, e in eng.tree_items(ef):
        compressed = e[0].numel() >= TRAIN_MIN_LEAF
        want = compressed and not (embed_kept_whole and path[0] == "embed")
        check(bool(e.any()) == want,
              f"train {label}: EF residuals of {path} "
              f"{'nonzero' if want else 'exactly 0'}")


def train_run(kern, zero, label, merges, **kw):
    """``launch.train.run`` at full width (stablelm-1.6b unless ``kw``
    names an arch), the counts set to 0 just before and read just after:
    the steps run, finite losses, ``merges`` launches of each merge kernel
    (None: one per leaf of at least ``TRAIN_MIN_LEAF`` elements a step),
    the wall a step, peak memory and, from CUDA events around each leaf's
    ``compress_merge_leaf``, the merge's ms a step. Returns (the run's
    result, its record, counts)."""
    import gc
    from repro_torch.dist import grad_sync as gs
    from repro_torch.launch import train as tr
    cfg = tr.TrainConfig(device="cuda", **kw)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    events = []
    merge = gs.compress_merge_leaf
    gs.compress_merge_leaf = timed_merge(merge, events)
    try:
        res, counts = drive(kern, lambda: tr.run(cfg))
    finally:
        gs.compress_merge_leaf = merge
    peak = torch.cuda.max_memory_allocated()
    steps = len(res["steps_run"])
    check(steps == cfg.steps, f"train {label}: steps run")
    big = sum(1 for _, p in gs.tree_items(res["params"])
              if p.numel() >= TRAIN_MIN_LEAF)
    if merges is None:
        merges = big * steps
    check(all(math.isfinite(v) for v in res["losses"]),
          f"train {label}: finite losses {res['losses']}")
    check_counts(counts, dict(zero, threshold_find=merges,
                              fused_merge=merges), f"train {label}")
    per = len(events) // steps
    check(len(events) == per * steps, f"train {label}: merge events")
    merge_ms = [sum(s.elapsed_time(e) for s, e in
                    events[i * per:(i + 1) * per]) for i in range(steps)]
    wall = res["wall_per_step"]
    rec = dict(config=kw, losses=res["losses"], wall_per_step_s=wall,
               compressed_leaves=big if cfg.compressed_pods else 0,
               first_step_s=wall[0], later_steps_s=wall[1:],
               merge_ms_per_step=merge_ms,
               merge_share=[m / 1e3 / t for m, t in zip(merge_ms, wall)],
               peak_memory_bytes=peak, launches=counts)
    if res["pod_crs"] is not None:
        rec["pod_crs"] = [float(c) for c in res["pod_crs"]]
    print(f"[train] {label}: losses {res['losses']}; wall a step (s) "
          f"first {wall[0]:.3f}, then {[round(t, 4) for t in wall[1:]]}; "
          f"merge {[round(m, 2) for m in merge_ms]} ms a step; peak "
          f"memory {peak / 1e9:.2f} GB; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    return res, rec, counts


def train_routes(model, params, ef, batch, pod_crs, record,
                 pods=TRAIN_PODS, twins=False, wire=None):
    """One step's ``pods`` pod gradients from the compressed run's final
    state through both routes of ``compress_merge_leaf``, leaf by leaf
    (``routes_on_leaf``): thresholds, masks, ks and EF residuals bit for
    bit, agg within 2*C*2^-24*gamma*sum|w v|. With ``twins``, also
    ``threshold_find`` and ``fused_merge`` against their twins on each
    leaf, bit for bit (``merge_twins_on_leaf``). ``wire``: the run's
    ``wire_cr`` (the CLI's default unless given), which caps the CRs."""
    from repro_torch.core import compression as comp
    from repro_torch.core.strategies import get as get_strategy
    from repro_torch.dist import grad_sync as gs
    from repro_torch.fed import engine as eng
    from repro_torch.launch import train as tr
    wire = np.float32(tr.TrainConfig().wire_cr if wire is None else wire)
    crs_np = np.clip(np.asarray(pod_crs, np.float32), 0.0, wire)
    crs = torch.from_numpy(crs_np).cuda()
    n_pods = pods
    w = torch.full((n_pods,), 1.0 / n_pods, device="cuda")
    strat = get_strategy("bcrs_opwa")
    pods, _, _ = gs.pod_gradients(model.loss_fn, params, batch, n_pods)
    worst_agg, worst_ratio, leaves, shapes = 0.0, 0.0, 0, set()
    for i, ((path, p), (_, e)) in enumerate(zip(eng.tree_items(params),
                                                eng.tree_items(ef))):
        dl, pods[i] = pods[i], None
        n = p.numel()
        if n < TRAIN_MIN_LEAF:
            continue
        ks = comp.k_for_ratio_traced(n, crs)
        want_ks = np.clip(np.round(crs_np * np.float32(n)), 1, n)
        check(np.array_equal(ks.cpu().numpy(), want_ks.astype(np.int32)),
              f"train ks of {path}")
        if twins:
            merge_twins_on_leaf(path, dl, e, w, ks)
            shapes.add(tuple(p.shape))
        agg_k, agg_p, d_max, ratio = routes_on_leaf(
            path, dl, e, w, ks, None, strat, tr.GAMMA, 1)
        del dl, agg_k, agg_p
        torch.cuda.empty_cache()
        worst_agg = max(worst_agg, d_max)
        worst_ratio = max(worst_ratio, ratio)
        leaves += 1
    out = dict(pods=n_pods, leaves=leaves, max_abs_agg_diff=worst_agg,
               max_agg_diff_over_bound=worst_ratio)
    if twins:
        out["kernels_bitwise_against_twins_on_leaf_shapes"] = sorted(shapes)
    record["routes"] = out
    print(f"[train routes] bcrs_opwa {n_pods} pods: {leaves} leaves, "
          f"thresholds, masks, ks and residuals bitwise; agg max |d| "
          f"{worst_agg:.3g} ({worst_ratio:.3g} of its bound)"
          + (f"; both kernels bitwise against their twins on "
             f"{len(shapes)} leaf shapes" if twins else ""))


#: columns of a leaf that ``merge_twins_on_leaf`` runs the twin over at once
TWIN_COLUMNS = 1 << 27


def merge_twins_on_leaf(path, dl, res, w, ks):
    """One leaf's ``[C, *leaf]`` pod gradients and EF residuals through
    ``threshold_find`` and ``fused_merge`` (OPWA, the trainer's gamma, D =
    1) and through their twins: thresholds, aggregate and new residuals
    bit for bit. These launches are comparisons, made outside any counted
    run."""
    from repro_torch.kernels import fused_merge as fm
    from repro_torch.kernels import threshold_find as tf
    from repro_torch.launch import train as tr
    c = dl.shape[0]
    x = dl.float().reshape(c, -1)
    r = res.reshape(c, -1)
    th = tf.threshold_find(x, ks, r)
    # the twin a client (row) at a time: its thresholds are per row, and
    # its int64 bit patterns of a full-width [C, n] leaf take 8 C n bytes
    k32 = ks.to(torch.int32)
    tp = torch.cat([tf.threshold_find_plain(x[i:i + 1], k32[i:i + 1],
                                            r[i:i + 1]) for i in range(c)])
    check(torch.equal(th, tp),
          f"threshold_find on {path} {list(dl.shape)}: the twin's")
    del tp
    kw = dict(opwa=True, gamma=tr.GAMMA, d=1, codec="none", scales=None)
    # the kernel's outputs wait on the host while the twin runs over
    # column blocks (it is elementwise along a leaf; whole, a full-width
    # leaf's temporaries do not fit beside the layout's four ranks)
    agg, new_r = (t.cpu() for t in fm.fused_merge(x, th, w, r, None, **kw))
    torch.cuda.empty_cache()
    n = x.shape[1]
    same = True
    for a in range(0, n, TWIN_COLUMNS):
        b = min(a + TWIN_COLUMNS, n)
        wa, wr = fm.fused_merge_plain(x[:, a:b], th, w, r[:, a:b], None,
                                      **kw)
        same &= (bits_equal(wa.cpu(), agg[a:b].contiguous())
                 and bits_equal(wr.cpu(), new_r[:, a:b].contiguous()))
        del wa, wr
    check(same, f"fused_merge on {path} {list(dl.shape)}: the twin's bits")
    del x, th, agg, new_r
    torch.cuda.empty_cache()


def train_wire_cr_one(model, params, batch, record):
    """``wire_cr = 1`` at 2 pods against the dense step over the same
    slices (``n_micro = 2``: the pods' gradients are its microbatches'),
    from the same params and batch, as ``tests/test_torch_grad_sync.py``
    holds it: EF residuals exactly 0, params within ``lr * (2*C*2^-24 *
    sum_c|w_c g_c| + r(g)) + ulp(p)`` (``r(g)`` one ulp of the merged
    gradient in the param's dtype where that is bf16, 0 in f32)."""
    from repro_torch.dist import grad_sync as gs
    from repro_torch.fed import engine as eng
    from repro_torch.launch import train as tr
    from repro_torch.optim import make_optimizer
    lr, c = tr.TrainConfig().lr, 2
    opt = make_optimizer("sgd", lr)
    p_d, _, m_d = gs.make_train_step(model, opt, n_micro=c)(params, (),
                                                             batch)
    state = gs.init_compressed_state(opt, params, n_pods=c)
    p_c, state, m_c = gs.make_compressed_train_step(
        model, opt, n_pods=c, wire_cr=1.0, gamma=tr.GAMMA)(
            params, state, batch, torch.ones(c, device="cuda"),
            torch.full((c,), 1.0 / c, device="cuda"))
    check(all(not bool(e.any()) for _, e in eng.tree_items(state["ef"])),
          "train wire_cr=1: EF residuals exactly 0")
    del state
    ld, lc = float(m_d["loss"]), float(m_c["loss"])
    check(abs(ld - lc) <= 2 * 2.0 ** -24 * abs(ld),
          f"train wire_cr=1: loss {lc} against dense {ld}")
    pods, _, _ = gs.pod_gradients(model.loss_fn, params, batch, c)
    same, worst = True, 0.0
    for i, ((path, a), (_, b)) in enumerate(zip(eng.tree_items(p_c),
                                                eng.tree_items(p_d))):
        g, pods[i] = pods[i].float(), None
        wg = (g.double().abs() / c).sum(0)
        r = (ulp_of(g.mean(0).to(a.dtype)) if a.dtype != torch.float32
             else torch.zeros_like(wg))
        bound = lr * (2 * c * 2.0 ** -24 * wg + r) + torch.maximum(
            ulp_of(a), ulp_of(b))
        diff = (a.double() - b.double()).abs()
        check(bool((diff <= bound).all()),
              f"train wire_cr=1: params of {path} within the bound")
        same &= same_bits(a.cpu(), b.cpu())
        worst = max(worst, float(diff.max()))
        del g, wg, r, bound, diff
    record["wire_cr_one"] = dict(pods=c, loss=lc, dense_loss=ld,
                                 params_bitwise_equal=bool(same),
                                 max_abs_param_diff=worst)
    print(f"[train wire_cr=1] {c} pods against the dense step (n_micro "
          f"{c}): EF exactly 0, params within the bound (bit for bit: "
          f"{bool(same)}, max |d| {worst:.3g}), loss {lc} / {ld}")


def train_restarts_reduced():
    """Dense adamw and the compressed step (2 pods, wire cr 0.1) at
    ``reduced()`` size on the card: stopped after the step-3 checkpoint,
    then resumed to 6 steps, equal to 6 uninterrupted steps bit for bit
    (params, optimizer state, EF residuals, losses)."""
    import tempfile
    from repro_torch.launch import train as tr
    base = dict(device="cuda", reduced=True, batch=4, seq=32)
    for label, kw in (("dense adamw", dict(optimizer="adamw")),
                      ("compressed", dict(compressed_pods=2, wire_cr=0.1))):
        full = tr.run(tr.TrainConfig(steps=6, **base, **kw))
        with tempfile.TemporaryDirectory() as tmp:
            part = tr.run(tr.TrainConfig(steps=4, checkpoint_dir=tmp,
                                         checkpoint_every=3, **base, **kw))
            resumed = tr.run(tr.TrainConfig(steps=6, checkpoint_dir=tmp,
                                            checkpoint_every=3, **base,
                                            **kw))
        check(resumed["resumed_from"] == 3
              and part["losses"][:3] + resumed["losses"] == full["losses"],
              f"train restart {label}: losses")
        check(tree_bits_equal(full["params"], resumed["params"])
              and tree_bits_equal(full["opt_state"], resumed["opt_state"]),
              f"train restart {label}: params and state bit for bit")
        print(f"[train] restart at reduced() size ({label}): 4 steps "
              f"stopped after the step-3 checkpoint, resumed to 6 == 6 "
              f"steps bit for bit")


def other_optimizers(kern, zero, big, batch, coeffs, runs, add,
                     profile_step):
    """``train_phase``'s adamw (dense and at 2 pods) and qtopk (4 pods)
    runs, at the depth ``at_depth`` sets (``CUT_LAYERS``, full width): 2
    steps each and one more profiled (what they hold, the optimizer state
    and the codec stage on every compressed leaf, does not depend on the
    depth)."""
    import gc
    import repro_torch.configs as configs
    from repro_torch.dist import grad_sync as gs
    from repro_torch.launch import train as tr
    from repro_torch.models import Model
    from repro_torch.optim import make_optimizer
    cfg0 = tr.TrainConfig(device="cuda")
    model = Model(configs.get_config(cfg0.arch), device="cuda")
    sgd = make_optimizer("sgd", cfg0.lr)
    adamw = make_optimizer("adamw", cfg0.lr)
    for label, merges, kw in (
            ("dense adamw", 0, dict(optimizer="adamw")),
            (f"adamw {TRAIN_ADAMW_PODS} pods", big * 2,
             dict(optimizer="adamw", compressed_pods=TRAIN_ADAMW_PODS))):
        res, rec, counts = train_run(kern, zero, label, merges, steps=2,
                                     **kw)
        add(counts)
        params, state = res["params"], res["opt_state"]
        if "compressed_pods" in kw:
            c = kw["compressed_pods"]
            step = gs.make_compressed_train_step(
                model, adamw, n_pods=c, wire_cr=cfg0.wire_cr,
                gamma=tr.GAMMA)
            crs = torch.from_numpy(np.asarray(res["pod_crs"],
                                              np.float32)).cuda()
            w = torch.full((c,), 1.0 / c, device="cuda")
            rec["profile"] = profile_step(
                lambda: step(params, state, batch, crs, w), rec)
        else:
            step = gs.make_train_step(model, adamw)
            rec["profile"] = profile_step(lambda: step(params, state, batch),
                                          rec)
        rec["n_layers"] = model.cfg.n_layers
        runs[label] = rec
        del res, params, state, step
        gc.collect()
        torch.cuda.empty_cache()

    # qtopk at 4 pods (fused_merge's int8 codec stage): 2 steps driven,
    # then one profiled
    label = f"qtopk {TRAIN_PODS} pods"
    torch.cuda.reset_peak_memory_stats()
    params = model.init(cfg0.seed)
    state = gs.init_compressed_state(sgd, params, n_pods=TRAIN_PODS)
    step = gs.make_compressed_train_step(
        model, sgd, n_pods=TRAIN_PODS, wire_cr=cfg0.wire_cr, gamma=tr.GAMMA,
        strategy="qtopk")
    crs = torch.full((TRAIN_PODS,), cfg0.wire_cr, device="cuda")
    events, walls, losses = [], [], []

    def qtopk_steps():
        nonlocal params, state
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch, crs, coeffs)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)

    merge = gs.compress_merge_leaf
    gs.compress_merge_leaf = timed_merge(merge, events)
    try:
        _, counts = drive(kern, qtopk_steps)
    finally:
        gs.compress_merge_leaf = merge
    add(counts)
    check_counts(counts, dict(zero, threshold_find=2 * big,
                              fused_merge=2 * big), f"train {label}")
    check(all(math.isfinite(v) for v in losses),
          f"train {label}: finite losses {losses}")
    check_ef("qtopk", state["ef"], embed_kept_whole=False)
    merge_ms = [sum(s.elapsed_time(e) for s, e in events[i * big:
                                                         (i + 1) * big])
                for i in range(2)]
    rec = dict(losses=losses, wall_per_step_s=walls, first_step_s=walls[0],
               later_steps_s=walls[1:], merge_ms_per_step=merge_ms,
               merge_share=[m / 1e3 / t for m, t in zip(merge_ms, walls)],
               peak_memory_bytes=torch.cuda.max_memory_allocated(),
               launches=counts, n_layers=model.cfg.n_layers)
    rec["profile"] = profile_step(
        lambda: step(params, state, batch, crs, coeffs), rec)
    runs[label] = rec
    print(f"[train] {label}: losses {losses}; wall a step (s) {walls}; "
          f"merge {[round(m, 2) for m in merge_ms]} ms a step; peak "
          f"{rec['peak_memory_bytes'] / 1e9:.2f} GB")
    del params, state, step
    gc.collect()
    torch.cuda.empty_cache()


def train_phase(kern, zero, record):
    """Centralised training (``launch.train``) at stablelm-1.6b's full width
    on the card, the CLI's defaults (B = 8, S = 256, lr 1e-2, seed 0): (1)
    dense sgd, 4 steps: no merge launch; (2) ``--compressed-pods 4
    --wire-cr 0.05`` (bcrs_opwa, sgd), 4 steps: each merge kernel launched
    once per leaf of at least 4096 elements a step, EF residuals nonzero
    on those leaves; each with the wall a step, peak memory, the merge's
    ms a step and one more step under the profiler (device idle share);
    (3) one step's pod gradients through both routes
    (``train_routes``); (4) ``wire_cr = 1`` against the dense step
    (``train_wire_cr_one``); (5) at ``CUT_LAYERS`` of the 24 layers (full
    width; ``other_optimizers``): adamw, dense and compressed at 2 pods,
    2 steps each, and qtopk (int8 codec stage) at 4 pods, 2 steps; each
    with one more step profiled; (6)
    restarts at ``reduced()`` size (``train_restarts_reduced``). Returns
    the launches per kernel over the driven runs."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.dist import grad_sync as gs
    from repro_torch.fed import engine as eng
    from repro_torch.launch import train as tr
    from repro_torch.models import Model
    from repro_torch.optim import make_optimizer
    t_phase = time.perf_counter()
    total = dict(zero)
    runs = {}
    cfg0 = tr.TrainConfig(device="cuda")
    model = Model(get_config(cfg0.arch), device="cuda")
    batch = tr._batch(cfg0, model.cfg, np.random.default_rng(1),
                      "cuda")
    sgd = make_optimizer("sgd", cfg0.lr)

    def add(counts):
        for name, n in counts.items():
            total[name] += n

    def profile_step(fn, rec):
        """One more step (warm: the run took the same shapes) under the
        profiler, its outputs dropped; the device's busy ms also over the
        run's median unprofiled step (the profiler slows the host)."""
        _, wall, by_name = device_profile(fn)
        out = busy_record(wall, by_name)
        if by_name:
            out["busy_share_of_unprofiled_step"] = (
                out["device_busy_ms"] / 1e3
                / float(np.median(rec["later_steps_s"])))
        print(f"[profile train step] {json.dumps(out)}")
        return out

    res, rec, counts = train_run(kern, zero, "dense sgd", 0,
                                 steps=TRAIN_STEPS)
    add(counts)
    items = eng.tree_items(res["params"])
    n_params = sum(p.numel() for _, p in items)
    big = sum(1 for _, p in items if p.numel() >= TRAIN_MIN_LEAF)
    step = gs.make_train_step(model, sgd)
    rec["profile"] = profile_step(lambda: step(res["params"], (), batch),
                                  rec)
    runs["dense sgd"] = rec
    del res, items
    gc.collect()
    torch.cuda.empty_cache()

    label = f"bcrs_opwa {TRAIN_PODS} pods"
    res, rec, counts = train_run(kern, zero, label, big * TRAIN_STEPS,
                                 steps=TRAIN_STEPS,
                                 compressed_pods=TRAIN_PODS)
    add(counts)
    params, state = res["params"], res["opt_state"]
    check_ef(label, state["ef"], embed_kept_whole=True)
    crs = torch.from_numpy(np.asarray(res["pod_crs"], np.float32)).cuda()
    coeffs = torch.full((TRAIN_PODS,), 1.0 / TRAIN_PODS, device="cuda")
    step = gs.make_compressed_train_step(
        model, sgd, n_pods=TRAIN_PODS, wire_cr=cfg0.wire_cr, gamma=tr.GAMMA)
    rec["profile"] = profile_step(lambda: step(params, state, batch, crs,
                                               coeffs), rec)
    runs[label] = rec
    train_routes(model, params, state["ef"], batch, res["pod_crs"], rec)
    del res, state, step
    gc.collect()
    torch.cuda.empty_cache()
    checks = {}
    train_wire_cr_one(model, params, batch, checks)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    with at_depth(CUT_LAYERS):
        other_optimizers(kern, zero, big, batch, coeffs, runs, add,
                         profile_step)

    train_restarts_reduced()
    record["train_phase"] = dict(
        model=cfg0.arch, parameters=n_params, compressed_leaves=big,
        runs=runs, checks=checks,
        seconds=time.perf_counter() - t_phase,
        launches={k: v for k, v in total.items() if v},
        restart="reduced() size, bit for bit")
    print(f"[train phase] {time.perf_counter() - t_phase:.1f} s, launches "
          f"{record['train_phase']['launches']}")
    return total


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
def device_profile(fn, host=None):
    """Run ``fn`` under ``torch.profiler``; returns (fn's result, wall ms,
    device ms by kernel name as {name: (ms, calls)}; empty when the
    profiler shows no device time). With a dict ``host``, also fills it
    with the host's self time by op name, {name: (ms, calls)}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.key_averages():
        # kernel events only: a CPU op's device time repeats its kernels'
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total:
            by_name[ev.key] = (ev.self_device_time_total / 1e3, ev.count)
        elif host is not None and ev.self_cpu_time_total:
            host[ev.key] = (ev.self_cpu_time_total / 1e3, ev.count)
    return out, wall_ms, by_name


def busy_record(wall_ms, by_name):
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return dict(
        wall_ms_under_profiler=wall_ms,
        device_busy_ms=busy_ms if by_name else "not measured",
        device_idle_share=(1 - busy_ms / wall_ms) if by_name
        else "not measured",
        top_kernels=[dict(name=k[:90], device_ms=v[0], calls=v[1])
                     for k, v in top])


def profile_fl_step(record):
    """One client's local SGD step of ``fl_train`` at stablelm-1.6b's full
    width (the CLI's batch of 4 x 128 tokens, bf16): after 3 warm-up
    steps, 3 steps timed in parts (forward, backward, the SGD update; each
    ending in a synchronize), then one under ``torch.profiler``: device
    time by kernel, idle share, host time by op and the launches a step."""
    from repro_torch.configs import get_config
    from repro_torch.fed import engine as eng
    from repro_torch.launch import fl_train as fl
    from repro_torch.models import Model
    cfg = fl.FLTrainConfig(engine="round", device="cuda")
    model = Model(get_config(cfg.arch), device="cuda")
    items = eng.tree_items(model.init(cfg.seed))
    toks = fl._round_batches(cfg, model.cfg.vocab_size, 0, 1)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[0, 0])).cuda()
             for k, v in toks.items()}
    lr = {p.dtype: torch.full((), cfg.lr, dtype=p.dtype, device="cuda")
          for _, p in items}

    def step():
        live = [p.detach().clone().requires_grad_(True) for _, p in items]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = model.loss_fn(eng.tree_from_items(
            zip([k for k, _ in items], live)), batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with torch.no_grad():
            for t, g in zip(live, grads):
                if g is not None:          # an unused leaf: g = 0
                    t.sub_(lr[t.dtype] * g)
        torch.cuda.synchronize()
        return [(t1 - t0) * 1e3, (t2 - t1) * 1e3,
                (time.perf_counter() - t2) * 1e3]

    for _ in range(3):
        step()
    parts = [step() for _ in range(3)]
    host = {}
    _, wall, by_name = device_profile(step, host)
    out = busy_record(wall, by_name)
    out["forward_backward_sgd_ms"] = parts
    out["launches_per_step"] = sum(
        n for name, (_, n) in host.items()
        if name in ("cudaLaunchKernel", "cuLaunchKernelEx",
                    "cudaLaunchKernelExC", "cudaMemcpyAsync",
                    "cudaMemsetAsync"))
    out["top_host_ops"] = [
        dict(name=k[:60], host_ms=v[0], calls=v[1]) for k, v in sorted(
            host.items(), key=lambda kv: -kv[1][0])[:8]]
    record["profile_fl_step"] = out
    print("[profile fl step]", json.dumps(out))


def profile_path(engine, acfg):
    """Where the device time of a path goes: ``run_fl`` (3 rounds, warm
    process) under ``torch.profiler``; device time summed by kernel name,
    and the busy share of the run's wall time. Reports "not measured" when
    the profiler shows no device time."""
    from repro_torch.fed.simulation import FLSimConfig, run_fl
    rounds = 3
    res, wall_ms, by_name = device_profile(lambda: run_fl(
        FLSimConfig(rounds=rounds), acfg, engine=engine, device="cuda"))
    busy_ms = sum(ms for ms, _ in by_name.values())
    return dict(
        busy_record(wall_ms, by_name),
        engine=engine, strategy=acfg.strategy, block_topk=acfg.block_topk,
        rounds=rounds,
        wall_per_round_ms_under_profiler=[t * 1e3 for t in
                                          res.wall_per_round],
        # against the rounds alone (setup and the first staging excluded;
        # the eval's few kernels stay in busy_ms)
        device_idle_share_of_rounds=(
            1 - busy_ms / (sum(res.wall_per_round) * 1e3)) if by_name
        else "not measured")


# ----------------------------------------------------------- serve phase
SERVE_ARCH = "stablelm-1.6b"
SERVE_BATCH = 4
ENTRY_SEQ = 2048              # the flash entry point's prompt
PROMPT, GEN = 128, 32         # the serve path's prompt and generated tokens
#: |prefill - decode| on the last prompt token's logits, bf16 at full width.
#: Both paths compute the same function and differ only in where they round
#: to bf16 and in summation order: R = 17 roundings a layer (two norms, q, k,
#: v, RoPE on q and k, the attention probabilities and output, wo, two
#: residual adds, up, gate, silu, the gated product, down), at each of which
#: the two may land on neighbouring bf16 values, a relative difference of
#: rms at most 2^-8. Taken as independent and carried to the logits at gain
#: ~1 (near-identity residual blocks at this init, then rms_norm and the
#: vocab projection), they add to an rms of 2^-8 * sqrt(L * R) times the
#: logits' rms; the largest of B * V (4e5) such differences stays below
#: Z = 6 of those (a normal exceeds 6 sigma with probability 2e-9).
LOGIT_R, LOGIT_Z = 17, 6.0
#: R for each family, counted the same way (tests/test_torch_models.py's
#: PREFILL_ROUNDINGS holds the same counts). hybrid 35: the dense 17; the
#: SSM branch's in_proj, its prefill conv (4 tap products, 3 partial sums,
#: the bias add, silu: 9 roundings that decode does in f32 and rounds
#: once), the f32 output's cast, silu(z), the gated product, its rms_norm,
#: out_proj (15); the two output norms and their sum (3). ssm 48: time-mix
#: 35 (ln1, shift - x, the mu_x product and sum, maa_w1, tanh, maa_w2, five
#: lerps of three roundings each, the decay LoRA's two products and tanh,
#: r, k, v, g, silu, the wkv output's cast, the group norm, the gated
#: product, wo, the residual add) and channel-mix 13 (ln2, shift - x, the
#: two lerps' products and sums, wk, the square, wv, wr, sigmoid, the
#: product, the residual add).
#: The bf16 bound holds the dense family only. Its premise, each layer's
#: roundings carried to the logits at gain ~1, fails for these two at
#: random init: rwkv6's first layers amplify a relative change ~60x, and
#: its bf16 gap (0.93) is as large as its logits' rms, so no bf16 bound
#: that holds could tell a right cache from a wrong one. Their
#: discriminating check is in f32 (``LOGIT32_K``); the bf16 gap is recorded.
#: encdec 21 a decoder block (self-attention 8: ln1, q, k, v, the
#: probabilities, the output, wo, the residual add; cross-attention 8, the
#: same from lnx; the MLP 5: ln2, up, gelu, down, the residual add), vlm
#: 17 a block (a self block's are the dense family's; a cross block's:
#: ln1, q, k, v, the probabilities, the output, wo, the gate's product,
#: the residual add, ln2, up, gate, silu, the gated product, down, the
#: gate's product, the residual add); tests/test_torch_cross.py counts
#: the same. Their check is in f32 too (``cross_prefill_f32``): the served
#: decode reads zero cross caches, so its bf16 gap to a prefill that reads
#: the frames or patches says nothing.
#: moe 28 a block (MLA's 14: ln1, wq_a, q_norm, wq_b, RoPE on q, wkv_a,
#: kv_norm, RoPE on the key, wk_b, wv_b, the probabilities, the output, wo,
#: the residual add; the MoE's 14: ln2, the experts' up, gate, silu, gated
#: product and down, the combine, the shared expert's five, its add, the
#: residual add), counted as ``tests/test_torch_moe_model.py`` does; only
#: recorded (the decode's absorbed MLA rounds elsewhere than the prefill's
#: expanded one, in f32), the check is ``moe_prefill_f32``.
LOGIT_ROUNDINGS = {"dense": LOGIT_R, "hybrid": 35, "ssm": 48, "encdec": 21,
                   "vlm": 17, "moe": 28}
#: f32 prefill against the f32 stepped decode, the bf16 params upcast (the
#: same weights, exactly) and an f32 cache. The two paths run the same
#: elementwise ops on the same inputs, which round alike; they differ only
#: where a sum runs in another order (a GEMM against a GEMV, a norm's mean,
#: the chunked GLA against the recurrence). Counted as the bf16 bound: the
#: same R sites a layer, each now up to sqrt(K) f32 roundings of relative
#: 2^-24 in rms (the random walk of a K-term sum's partial sums), K the
#: layer's longest contraction (d_ff): Z * 2^-24 * sqrt(L * R * K) *
#: rms(logits), ~1e-3 of the logits' rms at these widths. A wrong carry,
#: conv history, token shift or window moves the logits by their own size.
#: The elementwise sites, which differ nowhere, leave the slack that the
#: stack's gains (rwkv6: up to ~60 at random init) use.
LOGIT32_PROMPT, LOGIT32_BATCH = 256, 2     # two GLA chunks of 128


def logit_tolerance(n_layers: int, logits: torch.Tensor,
                    r: int = LOGIT_R) -> float:
    """Z * 2^-8 * sqrt(L * R) * rms(logits): the bf16 prefill-vs-decode
    bound (tests/test_torch_models.py holds 4-layer bf16 models on the CPU
    to the same formula)."""
    rms = float(logits.float().pow(2).mean().sqrt())
    return LOGIT_Z * 2.0 ** -8 * math.sqrt(n_layers * r) * rms


def logit_tolerance_f32(n_layers: int, logits: torch.Tensor, r: int,
                        k: int) -> float:
    """Z * 2^-24 * sqrt(L * R * K) * rms(logits): the f32 prefill-vs-decode
    bound (``LOGIT32_PROMPT``'s comment; tests/test_torch_models.py holds
    4-layer f32 models on the CPU to the same formula)."""
    rms = float(logits.float().pow(2).mean().sqrt())
    return LOGIT_Z * 2.0 ** -24 * math.sqrt(n_layers * r * k) * rms


#: flash kernel against twin: (label, B, Sq, Sk, H, Hkv, D, dtype, causal)
FLASH_CASES = (
    ("serve", 4, 2048, 2048, 32, 32, 64, torch.bfloat16, True),
    ("serve", 4, 2048, 2048, 32, 32, 64, torch.float32, True),
    ("yi-9b heads", 1, 2048, 2048, 32, 4, 128, torch.bfloat16, True),
    ("ragged", 1, 1000, 1000, 2, 2, 64, torch.bfloat16, True),
    ("ragged", 1, 1000, 1000, 2, 2, 64, torch.float32, True),
    ("ragged", 1, 700, 1000, 2, 2, 64, torch.bfloat16, True),
    ("top-left", 1, 128, 384, 1, 1, 64, torch.bfloat16, True),
    ("top-left", 1, 128, 384, 1, 1, 64, torch.float32, True),
    ("non-causal", 1, 256, 256, 2, 2, 64, torch.bfloat16, False),
    ("non-causal", 1, 256, 256, 2, 2, 64, torch.float32, False),
    ("32k", 1, None, None, 32, 32, 64, torch.bfloat16, True),
)
BLK = 128                     # ops.flash_attention's default blocks


def heads_flat(x: torch.Tensor) -> torch.Tensor:
    """[B, S, H, D] -> [B*H, S_pad, D], zero-padded to a BLK multiple as
    ``ops.flash_attention`` pads it."""
    b, s, h, d = x.shape
    t = x.transpose(1, 2).reshape(b * h, s, d)
    return torch.nn.functional.pad(t, (0, 0, 0, (-s) % BLK)).contiguous()


def flash_agreement(got, want, v, sk):
    """Kernel against twin, every element. f32: within the summation-order
    bound B = (D + Sk) * 2^-24 * max|v| plus 4 ULP of max|v| for expf (the
    output is a convex combination of v rows, so |o| <= max|v|). bf16: each
    side rounds its own f32 result, so within B plus one bf16 ULP of the
    larger of the two (half an ULP each): near zero, where the f32 sum
    cancels, B dominates and the difference can be many bf16 ULPs of the
    value. Returns (ok, max |d|, B, the largest difference in bf16 ULPs or
    None for f32)."""
    diff = (got.double() - want.double()).abs()
    err = float(diff.max())
    bound = (got.shape[-1] + sk + 8) * 2.0 ** -24 * float(v.abs().max())
    if got.dtype == torch.float32:
        return err <= bound, err, bound, None
    return (bool((diff <= bf16_ulp(got, want) + bound).all()), err, bound,
            float((diff / bf16_ulp(got, want)).max()))


def bf16_ulp(a, b):
    """One bf16 ULP (8 significant bits) of the larger of |a| and |b|."""
    mag = torch.maximum(a.float().abs(), b.float().abs())
    _, e = torch.frexp(mag)
    return torch.pow(2.0, (e - 8).double())


def wgmma_agreement(got, want, bound):
    """The wgmma route's stated bound (``flash_attention.
    wgmma_twin_and_bound``, derived in ``csrc/flash_attention_wgmma.cu``):
    |got - want| <= bound + one bf16 ULP of the larger magnitude. Returns
    (ok, max |d|, the largest |d| / limit)."""
    diff = (got.double() - want.double()).abs()
    limit = bound + bf16_ulp(got, want)
    return (bool((diff <= limit).all()), float(diff.max()),
            float((diff / limit).max()))


#: the planted fault: the key tile of 64 a faulty kernel skips, at the
#: middle of the longest FLASH_CASES sequence (keys 16384..16447 at 32k)
def fault_tile(sk: int) -> int:
    return sk // 64 // 2


def twin_without_key_tile(q, k, v, tile, causal):
    """The wgmma twin's arithmetic with one key tile of 64 left out: what
    a kernel that skips that tile (a ring-phase slip, a wrong tile count)
    would return."""
    from repro_torch.kernels import flash_attention as fa
    bh, sq, d = q.shape
    qf = q.float()
    q_pos = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((bh, sq), fa.NEG_INF, device=q.device)
    l = torch.zeros((bh, sq), device=q.device)
    acc = torch.zeros((bh, sq, d), device=q.device)
    for k0 in range(0, k.shape[1], 64):
        if k0 // 64 == tile:
            continue
        s = (qf @ k[:, k0:k0 + 64].float().transpose(1, 2)) / d ** 0.5
        if causal:
            k_pos = k0 + torch.arange(64, device=q.device)[None, :]
            s = torch.where(q_pos >= k_pos, s, fa.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None]).to(torch.bfloat16).float()
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + p @ v[:, k0:k0 + 64].float()
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(torch.bfloat16)


def flash_case(label, b, sq, sk, h, hkv, d, dtype, causal, seed):
    """q [B, Sq, H, D] and k, v [B, Sk, H, D] normals on the card; kv drawn
    with Hkv heads and broadcast in ``attend``'s grouping (q head i reads kv
    head i // (H / Hkv))."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, sq, h, d, device="cuda", generator=g).to(dtype)
    k = torch.randn(b, sk, hkv, d, device="cuda", generator=g).to(dtype)
    v = torch.randn(b, sk, hkv, d, device="cuda", generator=g).to(dtype)
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    return q, k, v


def causal_pairs(sq, sk, causal):
    """(query, key) pairs the mask keeps: positions aligned at the top left."""
    if not causal:
        return sq * sk
    n = min(sq, sk)
    return n * (n + 1) // 2 + max(0, sq - sk) * sk


def flash_timing(kernel, label, name, qb, kb, vb, b, h, sq, sk, d, causal,
                 fn, twin):
    """Kernel, twin and SDPA times on the same [BH, S, D] tensors (SDPA on
    their [B, H, S, D] view) beside the bound."""
    big = sk > 8192
    esize = qb.element_size()
    nbytes = 4 * b * h * sq * d * esize      # q, k, v read; o written
    ops_n = 4 * b * h * causal_pairs(sq, sk, causal) * d
    peak = BF16_OPS_PER_S if qb.dtype == torch.bfloat16 else F32_OPS_PER_S
    q4, k4, v4 = (t.view(b, h, -1, d) for t in (qb, kb, vb))
    row = timing_row(
        kernel, label, name, nbytes, ops_n,
        time_ms(fn, 3 if big else 20, 1 if big else 2),
        time_ms(twin, 1 if big else 5, 0 if big else 1),
        f"F.scaled_dot_product_attention(is_causal={causal})",
        time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal), 3 if big else 20,
            1 if big else 2), peak)
    print("[timing]", json.dumps(row))
    return row


def flash_parity_and_timings(record):
    """Every FLASH_CASES case on the same padded [BH, S, D] tensors.

    The present kernel (``flash_attention_cuda``) against its twin: f32
    within the summation-order bound; bf16 within it plus one bf16 ULP, and
    equal bit for bit to the f32 kernel on the upcasts, rounded. The wgmma
    kernel (every bf16 case: D 64 and 128, padded to 128) against its twin
    within ``wgmma_twin_and_bound`` plus one bf16 ULP, and that twin against
    the f32 twin on the upcasts within its ``both_round=False`` bound plus
    one bf16 ULP; at the serve shape and 32k the check must also reject the
    twin's output with the middle key tile left out (a planted fault). The
    ragged cases also go through ``ops.flash_attention``, which must return
    the padded kernel call's rows (the wgmma kernel's in bf16). Timed: the
    serve shape, yi-9b's heads and 32k, kernel, twin and SDPA."""
    from repro_torch.configs import SHAPES
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    s32k = SHAPES["prefill_32k"].seq_len
    cases, rows, worst, worst_wg = [], [], 0.0, 0.0
    for seed, (label, b, sq, sk, h, hkv, d, dtype, causal) in enumerate(
            FLASH_CASES):
        sq, sk = sq or s32k, sk or s32k
        q, k, v = flash_case(label, b, sq, sk, h, hkv, d, dtype, causal,
                             400 + seed)
        qb, kb, vb = heads_flat(q), heads_flat(k), heads_flat(v)
        got = fa.flash_attention_cuda(qb, kb, vb, causal=causal)
        want = fa.flash_attention_plain(qb, kb, vb, causal=causal)
        torch.cuda.synchronize()
        ok, err, bound, ulps = flash_agreement(got, want, vb, kb.shape[1])
        name = f"{label} [{b}, {sq}x{sk}, {h}, {d}] {str(dtype)[6:]}" + (
            "" if causal else " non-causal")
        what = f"bound {bound:.3g}" + ("" if ulps is None else
                                       f" + 1 ULP; max {ulps:.3g} bf16 ULPs")
        check(ok, f"flash_attention {name}: max |d| {err:.3g}, {what}")
        entry = dict(case=name, max_abs_err=err, bound=bound)
        msg = f"[flash] {name}: max |kernel - twin| {err:.3g} ({what})"
        if dtype == torch.bfloat16:
            # the bf16 kernel runs the f32 kernel's arithmetic on exact
            # upcasts: it must be that kernel's output rounded to bf16
            up = fa.flash_attention_cuda(qb.float(), kb.float(), vb.float(),
                                         causal=causal)
            check(torch.equal(got, up.to(torch.bfloat16)),
                  f"flash_attention {name} == bf16(f32 kernel on upcasts)")
            twin32 = fa.flash_attention_plain(qb.float(), kb.float(),
                                              vb.float(), causal=causal)
            ok32, err32, _, _ = flash_agreement(up, twin32, vb.float(),
                                                kb.shape[1])
            check(ok32, f"flash_attention {name} upcast to f32: max |d| "
                        f"{err32:.3g} > bound {bound:.3g}")
            # the wgmma route: kernel against its twin, twin against f32
            wg = fa.flash_attention_wgmma_cuda(qb, kb, vb, causal=causal)
            wg_twin, bound = fa.wgmma_twin_and_bound(qb, kb, vb,
                                                     causal=causal)
            torch.cuda.synchronize()
            ok_k, err_k, r_k = wgmma_agreement(wg, wg_twin, bound)
            check(ok_k, f"flash_attention_wgmma {name}: max |d| {err_k:.3g}, "
                        f"{r_k:.3g} of its bound")
            twin1, bound1 = fa.wgmma_twin_and_bound(
                qb, kb, vb, causal=causal, both_round=False)
            ok_t, err_t, r_t = wgmma_agreement(twin1, twin32, bound1)
            check(ok_t, f"flash_attention_wgmma twin {name} vs f32 twin: "
                        f"max |d| {err_t:.3g}, {r_t:.3g} of its bound")
            worst_wg = max(worst_wg, err_k)
            entry.update(max_bf16_ulps=ulps, f32_upcast_max_abs_err=err32,
                         wgmma_max_abs_err=err_k, wgmma_share_of_bound=r_k,
                         wgmma_bound_median=float(bound.median()),
                         wgmma_twin_vs_f32_max_abs=err_t,
                         wgmma_twin_share_of_bound=r_t)
            msg += (f"; bf16 == bf16(f32 kernel); f32 upcast max |d| "
                    f"{err32:.3g}; wgmma vs its twin {err_k:.3g} ({r_k:.3g} "
                    f"of bound), twin vs f32 twin {err_t:.3g} ({r_t:.3g})")
            if label in ("serve", "32k"):
                # the check must reject a kernel that skips one key tile
                tile = fault_tile(kb.shape[1])
                bad = twin_without_key_tile(qb, kb, vb, tile, causal)
                ok_f, err_f, r_f = wgmma_agreement(bad, wg_twin, bound)
                check(not ok_f, f"flash_attention_wgmma {name}: the check "
                                f"passes a kernel that skips key tile {tile}")
                entry.update(planted_fault=f"key tile {tile} skipped",
                             planted_fault_max_abs=err_f,
                             planted_fault_share_of_bound=r_f)
                msg += (f"; skipping key tile {tile} gives {err_f:.3g} "
                        f"({r_f:.3g} of bound): rejected")
                del bad
            del up, twin32, wg_twin, bound, twin1, bound1
        if label == "ragged":
            entry_out = ops.flash_attention(q, k, v, causal=causal)
            ref = wg if dtype == torch.bfloat16 else got
            flat = ref[:, :sq].reshape(b, h, sq, d).transpose(1, 2)
            check(torch.equal(entry_out, flat),
                  f"ops.flash_attention {name} == the padded kernel call")
        worst = max(worst, err)
        cases.append(entry)
        print(msg)
        if label in ("serve", "32k", "yi-9b heads"):
            args = (label, name, qb, kb, vb, b, h, sq, sk, d, causal)
            if label != "yi-9b heads":
                rows.append(flash_timing(
                    "flash_attention", *args,
                    lambda: fa.flash_attention_cuda(qb, kb, vb),
                    lambda: fa.flash_attention_plain(qb, kb, vb)))
            if dtype == torch.bfloat16:
                rows.append(flash_timing(
                    "flash_attention_wgmma", *args,
                    lambda: fa.flash_attention_wgmma_cuda(qb, kb, vb),
                    lambda: fa.flash_attention_wgmma_plain(qb, kb, vb)))
        del q, k, v, qb, kb, vb, got, want
        if dtype == torch.bfloat16:
            del wg
        torch.cuda.empty_cache()
    record["flash_cases"] = cases
    record["flash_timings"] = rows
    return worst, worst_wg, rows


def serve_model():
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    model = Model(get_config(SERVE_ARCH), device="cuda")
    return model, model.init(0)


def layer0_qkv(model, params, batch, seq):
    """Layer 0's q, k, v [B, S, H, D] (RoPE applied) for a random prompt:
    ``rms_norm(embed_lookup(...))``, ``qkv_proj``, ``apply_rope``."""
    from repro_torch.models.attention import qkv_proj
    from repro_torch.models.layers import apply_rope, embed_lookup, rms_norm
    from repro_torch.models.transformer import layer_params
    cfg = model.cfg
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (batch, seq)), device="cuda")
    p0 = layer_params(params["layers"], 0)
    with torch.no_grad():
        h = rms_norm(embed_lookup(params["embed"]["w"], tokens), p0["ln1"],
                     cfg.norm_eps)
        q, k, v = qkv_proj(p0["attn"], h, cfg.n_heads, cfg.n_kv_heads,
                           cfg.resolved_head_dim)
        pos = torch.arange(seq, device="cuda")
        return (apply_rope(q, pos, cfg.rope_theta),
                apply_rope(k, pos, cfg.rope_theta), v)


def flash_entry_point(kern, zero, model, params, record):
    """``ops.flash_attention`` on the model's own layer-0 tensors (B = 4,
    2048 tokens) against ``attention.attend`` — the reference's
    test_matches_model_attend on the card — in bf16 (the wgmma kernel) and
    in f32 (the present kernel), with the launch counters reset just before
    and read just after. f32 within the reference's 1e-5 (atol and rtol).
    bf16 within (2^-7 + 2 * 2^-8 / (1 - 2^-8)) * max|v|: ``attend`` rounds
    its probabilities (2^-9 relative each, at most 2^-9 * max|v| on the
    output) and both round the output to bf16 (2^-9 * |o| <= 2^-9 * max|v|
    each), which PR 15 held to 2^-7 * max|v|; the wgmma route also rounds
    each weight to bf16 before its renormalised sum (2^-8 relative each, so
    at most 2^-8 / (1 - 2^-8) * (max|v| + |o|) on the output)."""
    from repro_torch.kernels import ops
    from repro_torch.models.attention import attend
    q, k, v = layer0_qkv(model, params, SERVE_BATCH, ENTRY_SEQ)

    def run():
        return {dt: ops.flash_attention(q.to(dt), k.to(dt), v.to(dt),
                                        causal=True)
                for dt in (torch.bfloat16, torch.float32)}

    outs, counts = drive(kern, run)
    check_counts(counts, dict(zero, flash_attention=1,
                              flash_attention_wgmma=1),
                 "flash entry point on the model's tensors")
    out = {"launches": counts, "shape": list(q.shape)}
    for dt, f in outs.items():
        with torch.no_grad():
            a = attend(q.to(dt), k.to(dt), v.to(dt), causal=True)
        diff = (f.double() - a.double()).abs()
        if dt == torch.float32:
            ok = bool((diff <= 1e-5 + 1e-5 * a.double().abs()).all())
            tol = "atol = rtol = 1e-5"
        else:
            bound = (2.0 ** -7 + 2 * 2.0 ** -8 / (1 - 2.0 ** -8)) * float(
                v.float().abs().max())
            ok = float(diff.max()) <= bound
            tol = f"(2^-7 + 2^-7 / (1 - 2^-8)) * max|v| = {bound:.4g}"
        name = str(dt)[6:]
        check(bool(torch.isfinite(f).all()) and ok,
              f"flash entry point vs attend ({name}): max |d| "
              f"{float(diff.max()):.3g}, {tol}")
        out[name] = dict(max_abs_diff=float(diff.max()), tolerance=tol)
        print(f"[flash entry] {name} {list(q.shape)}: max |flash - attend| "
              f"{float(diff.max()):.3g} ({tol}); launches {counts}")
    record["flash_entry_point"] = out
    return counts


def nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(nbytes(t) for t in tree.values())
    return tree.numel() * tree.element_size()


def decode_bound_ms(model, params, batch, positions, cache_len=None):
    """Bytes a decode step must move at cache length ``positions`` (mean
    over the timed steps), over the HBM rate: every weight a step reads
    (all but the embedding table, of which B rows, and the encoder,
    ``vis_proj`` and the MTP head, which decode never reads; every expert
    of a MoE layer), the K and V cache up to the position (each layer's
    window at most) and the new K/V entries (MLA: its latent and rope
    key), the cross caches read whole (encdec's ``cache_len`` positions, vlm's
    patches), the recurrent state (hymba's conv history and SSM state,
    rwkv's token shifts and wkv state), read once and written once, and
    the logits. Returns (ms, total bytes, state bytes)."""
    cfg = model.cfg
    emb = params["embed"]["w"]
    unread = nbytes(emb) + sum(nbytes(params[k]) for k in ("encoder",
                                                           "vis_proj", "mtp")
                               if k in params)
    weights = nbytes(params) - unread + batch * emb.shape[1] * \
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
    state = nbytes(one) - sum(nbytes(one[k]) for k in ("k", "v", "ck", "cv",
                                                      "mla") if k in one)
    del one
    total = weights + kv + cross + 2 * state + batch * model.v_pad * 2
    return total / HBM_BYTES_PER_S * 1e3, total, state


def timed_prefill(kern, zero, model, params, prompt, memory=None):
    """``Model.prefill`` once to warm, then once timed (host clock ending
    in a synchronize), the launch counters reset just before and read just
    after both (zero: no kernel on this path); ``memory`` holds the cross
    families' frames or patches. Returns (logits, cache, ms)."""
    batch = dict(memory or {}, tokens=prompt)

    def run():
        with torch.no_grad():
            model.prefill(params, batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pf, cache = model.prefill(params, batch)
            torch.cuda.synchronize()
            return pf, cache, (time.perf_counter() - t0) * 1e3

    out, counts = drive(kern, run)
    check_counts(counts, zero, f"{model.cfg.name} prefill")
    return out


def serve_path(kern, zero, model, params, record, key="serve"):
    """``launch.serve.generate`` at full width: a 128-token prompt stepped
    through ``decode_step`` at B = 4, then 32 greedy tokens, with the launch
    counters reset just before and read just after (this path runs none of
    the port's kernels: attention is ``attend`` / ``decode_attend`` and
    GLA plain torch, as in the reference); ``Model.prefill`` over the same
    prompt against the decode logits after the last prompt token: for the
    dense family within ``logit_tolerance``, for hybrid and ssm recorded
    (their check is ``prefill_vs_decode_f32``). The cross families'
    prefill reads frames or patches (``cross_memory``) that the served
    decode never sees (its cross caches stay zero, as in the reference),
    so their gap is not recorded; their check is ``cross_prefill_f32``."""
    from repro_torch.launch.serve import generate
    cfg = model.cfg
    dense = cfg.family == "dense"
    cross = cfg.family in CROSS_FAMILIES
    memory = cross_memory(cfg, SERVE_BATCH, 3) if cross else None
    prompt = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (SERVE_BATCH, PROMPT)), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    res, counts = drive(kern, lambda: generate(model, params, prompt, GEN))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_counts(counts, zero, f"{cfg.name} serve path")
    check(res["tokens"].shape == (SERVE_BATCH, GEN),
          f"{cfg.name} serve: tokens shape")
    check(bool(torch.isfinite(res["logits"]).all())
          and bool(torch.isfinite(res["prompt_logits"]).all()),
          f"{cfg.name} serve: finite logits")
    pf, cache, prefill_ms = timed_prefill(kern, zero, model, params, prompt,
                                          memory)
    del memory
    check(cache is None, "prefill returns no cache (as the reference)")
    check(bool(torch.isfinite(pf).all()), f"{cfg.name} prefill: finite")
    dec = res["prompt_logits"][:, :cfg.vocab_size].float()
    pre = pf[:, :cfg.vocab_size].float()
    tol = logit_tolerance(cfg.n_layers, dec, LOGIT_ROUNDINGS[cfg.family])
    diff = float((pre - dec).abs().max())
    top2 = dec.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    same = dec.argmax(-1) == pre.argmax(-1)
    if dense:
        check(diff <= tol, f"{cfg.name} prefill vs decode logits: max |d| "
                           f"{diff:.4g} > {tol:.4g}")
        # each logit may move by tol, so a pair can swap only within 2 * tol
        check(bool(same[margin > 2 * tol].all()),
              f"{cfg.name} prefill vs decode: argmax agrees where the top-2 "
              "margin exceeds 2 * tol")
    step_ms = res["t_gen"] / (GEN - 1) * 1e3
    bound_ms, step_bytes, state_bytes = decode_bound_ms(
        model, params, SERVE_BATCH, PROMPT + GEN // 2, PROMPT + GEN)
    out = dict(
        arch=cfg.name, batch=SERVE_BATCH, prompt=PROMPT, gen=GEN,
        n_params=cfg.n_params(), launches=counts,
        stepped_prefill_ms=res["t_prefill"] * 1e3,
        stepped_prefill_ms_per_token=res["t_prefill"] * 1e3 / PROMPT,
        prefill_forward_ms=prefill_ms, decode_ms_per_step=step_ms,
        tokens_per_s=SERVE_BATCH * GEN / res["t_gen"],
        decode_bound_ms=bound_ms, decode_step_bytes=step_bytes,
        recurrent_state_bytes=state_bytes, peak_gb_generate=peak_gb,
        prefill_vs_decode_max_abs=diff,
        logits_rms=float(dec.pow(2).mean().sqrt()),
        argmax_agree=same.tolist(), top2_margin=margin.tolist(),
        sample_tokens=res["tokens"][0, :16].tolist())
    if dense:
        out.update(logit_tol=tol, logit_tol_formula=(
            f"6 * 2^-8 * sqrt(L * {LOGIT_R}) * rms(logits)"))
    elif cross:
        for k in ("prefill_vs_decode_max_abs", "argmax_agree",
                  "top2_margin"):
            del out[k]
        torch.cuda.empty_cache()
        out["f32"] = cross_prefill_f32(
            kern, zero, *cut_model(model, params, CROSS_F32_LAYERS[
                cfg.family] or cfg.n_layers))
    else:
        out["bf16_gap_over_dense_form"] = diff / tol
        if cfg.family != "moe":     # moe's: moe_prefill_f32, bf16 freed
            torch.cuda.empty_cache()
            out["f32"] = prefill_vs_decode_f32(
                kern, zero, *cut_model(model, params, CUT_LAYERS))
    print(f"[{key}] {cfg.name} B={SERVE_BATCH}: stepped prefill "
          f"{PROMPT} tok {out['stepped_prefill_ms']:.1f} ms, "
          f"Model.prefill {prefill_ms:.2f} ms, decode "
          f"{step_ms:.3f} ms a step (bound {bound_ms:.3f} ms, "
          f"{step_bytes / 1e9:.3f} GB), {out['tokens_per_s']:.1f} tok/s; "
          f"peak {peak_gb:.2f} GB"
          + ("" if cross else f"; bf16 prefill vs decode max |d| "
             f"{diff:.4g} (rms {out['logits_rms']:.4g}; "
             + (f"tol {tol:.4g})" if dense else "recorded)")))
    record[key] = out
    return out


def prefill_vs_decode_f32(kern, zero, model, params):
    """``Model.prefill`` against ``generate``'s stepped decode in f32 at full
    width: the bf16 params upcast (the same weights, exactly), an f32 cache,
    a ``LOGIT32_PROMPT``-token prompt (two GLA chunks) at B =
    ``LOGIT32_BATCH``, the launch counters reset just before and read just
    after each (zero); the last prompt token's logits within
    ``logit_tolerance_f32`` at the family's R and K = d_ff, argmax equal
    where the top-2 margin exceeds 2 * tol."""
    from repro_torch.launch.serve import generate
    from repro_torch.tree import tree_from_items, tree_items
    cfg = model.cfg
    r = LOGIT_ROUNDINGS[cfg.family]
    p32 = tree_from_items([(k, t.float() if t.is_floating_point() else t)
                           for k, t in tree_items(params)])
    prompt = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (LOGIT32_BATCH, LOGIT32_PROMPT)), device="cuda")
    res, counts = drive(kern, lambda: generate(model, p32, prompt, 1,
                                               torch.float32))
    check_counts(counts, zero, f"{cfg.name} f32 stepped decode")

    def fwd():
        with torch.no_grad():
            return model.prefill(p32, {"tokens": prompt})[0]

    pf, counts = drive(kern, fwd)
    check_counts(counts, zero, f"{cfg.name} f32 prefill")
    del p32
    dec = res["prompt_logits"][:, :cfg.vocab_size]
    pre = pf[:, :cfg.vocab_size]
    check(dec.dtype == torch.float32 and pre.dtype == torch.float32
          and bool(torch.isfinite(dec).all())
          and bool(torch.isfinite(pre).all()),
          f"{cfg.name} f32 prefill and decode: finite f32 logits")
    tol = logit_tolerance_f32(cfg.n_layers, dec, r, cfg.d_ff)
    diff = float((pre - dec).abs().max())
    check(diff <= tol, f"{cfg.name} f32 prefill vs decode logits: max |d| "
                       f"{diff:.4g} > {tol:.4g}")
    top2 = dec.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    same = dec.argmax(-1) == pre.argmax(-1)
    check(bool(same[margin > 2 * tol].all()),
          f"{cfg.name} f32 prefill vs decode: argmax agrees where the top-2 "
          "margin exceeds 2 * tol")
    rms = float(dec.pow(2).mean().sqrt())
    out = dict(batch=LOGIT32_BATCH, prompt=LOGIT32_PROMPT,
               n_layers=cfg.n_layers, max_abs=diff, tol=tol, over_tol=diff / tol, logits_rms=rms,
               formula=f"6 * 2^-24 * sqrt(L * {r} * {cfg.d_ff}) * "
                       "rms(logits)",
               argmax_agree=same.tolist(), top2_margin=margin.tolist())
    print(f"[f32 prefill vs decode] {cfg.name} at {cfg.n_layers} layers "
          f"B={LOGIT32_BATCH} S={LOGIT32_PROMPT}: max |d| {diff:.4g} = {diff / tol:.3g} of "
          f"tol {tol:.4g} ({out['formula']}; rms {rms:.4g})")
    return out


def profile_decode(model, params):
    """3 decode steps at B = 4 (cache of 160, position 128) under the
    profiler: device time by kernel, the idle share and the launches a
    step (from a fresh cache: the recurrent families' states are zeros)."""
    cache = model.init_cache(SERVE_BATCH, PROMPT + GEN)
    toks = torch.zeros(SERVE_BATCH, dtype=torch.long, device="cuda")

    def steps():
        with torch.no_grad():
            for i in range(3):
                model.decode_step(params, cache, toks, PROMPT + i)

    steps()                                            # warm
    host = {}
    _, wall_ms, by_name = device_profile(steps, host)
    top_host = sorted(host.items(), key=lambda kv: -kv[1][0])[:12]
    return dict(busy_record(wall_ms, by_name), steps=3, batch=SERVE_BATCH,
                kernel_launches_per_step=sum(c for _, c in by_name.values())
                / 3,
                top_host_ops=[dict(name=k[:60], self_host_ms=v[0], calls=v[1])
                              for k, v in top_host])


def serve_phase(kern, zero, record, profile):
    """The serve phase; returns (the present flash kernel's and the wgmma
    kernel's worst errors against their twins, the timing rows, the flash
    entry point's launch counts)."""
    t0 = time.perf_counter()
    worst, worst_wg, rows = flash_parity_and_timings(record)
    model, params = serve_model()
    counts = flash_entry_point(kern, zero, model, params, record)
    torch.cuda.empty_cache()
    serve_path(kern, zero, model, params, record)
    if profile:
        record["profile_decode"] = profile_decode(model, params)
        print("[profile decode]", json.dumps(record["profile_decode"]))
    del model, params
    torch.cuda.empty_cache()
    print(f"[serve phase] {time.perf_counter() - t0:.1f} s")
    return worst, worst_wg, rows, counts


# ------------------------------------------------- recurrent serve phase
RECURRENT_ARCHS = ("hymba-1.5b", "rwkv6-1.6b")
LONG_PROMPT = 2048            # Model.prefill timed again: hymba's window of
                              # 1024 bites in 29 of its 32 layers
GLA_CHUNKS = 4                # chunked_gla vs reference_recurrence, B = 1


def layer0_gla_inputs(model, params, seq):
    """Layer 0's chunked-GLA inputs for a random ``seq``-token prompt at
    B = 1, as prefill builds them (``mamba.ssd_inputs``: scalar decay,
    inclusive; ``rwkv6.wkv_inputs``: per-channel decay and the bonus u).
    Returns (r, k, v, g, u, inclusive)."""
    from repro_torch.models import mamba, rwkv6
    from repro_torch.models.layers import embed_lookup, layer_norm, rms_norm
    from repro_torch.models.transformer import layer_params
    cfg = model.cfg
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, seq)), device="cuda")
    p0 = layer_params(params["layers"], 0)
    with torch.no_grad():
        x = embed_lookup(params["embed"]["w"], tokens)
        if cfg.family == "ssm":
            x = layer_norm(x, params["ln0_s"], params["ln0_b"], cfg.norm_eps)
            h = layer_norm(x, p0["ln1_s"], p0["ln1_b"], cfg.norm_eps)
            r, k, v, g, u, _ = rwkv6.wkv_inputs(
                p0["tm"], h, n_heads=cfg.n_heads, rwkv_cfg=cfg.rwkv)
            return r, k, v, g, u, False
        h = rms_norm(x, p0["ln1"], cfg.norm_eps)
        q, k, v, g, _, _ = mamba.ssd_inputs(p0["ssm"], h,
                                            d_model=cfg.d_model,
                                            ssm_cfg=cfg.ssm)
        return q, k, v, g, None, True


def gla_against_recurrence(model, params):
    """``chunked_gla`` over 4 chunks on layer 0's own inputs against the
    port's ``reference_recurrence`` on the card (the carry across chunks,
    which a 128-token prompt does not reach), outputs and final state within
    ``gla.summation_bound``: (c + Dk + 8) * 2^-24 * A + 2 (c + 1) * 2^-24 *
    A_G, A the recurrence in f64 on the magnitudes and A_G the same with
    each product weighted by the log-decay sums G (``sum |g|`` over a
    chunk) of the chunks it crosses, the bound the CPU tests hold both
    packages to. Prints the largest G of these inputs. Both timed (CUDA
    events)."""
    from repro_torch.models import gla
    chunk = (model.cfg.rwkv or model.cfg.ssm).chunk
    r, k, v, g, u, inclusive = layer0_gla_inputs(model, params,
                                                 GLA_CHUNKS * chunk)
    kw = dict(u=u, inclusive=inclusive)
    big_g = float(g.double().abs().unflatten(2, (GLA_CHUNKS, chunk)).sum(
        3).max())

    def over(got, want, bound):
        """max |got - want| / bound (inf where a zero bound is exceeded)."""
        d = (got.double() - want.double()).abs()
        return float(torch.where(bound > 0, d / bound,
                                 torch.where(d > 0, math.inf, 0.0)).max())

    with torch.no_grad():
        o, s = gla.chunked_gla(r, k, v, g, chunk=chunk, **kw)
        o_r, s_r = gla.reference_recurrence(r, k, v, g, **kw)
        bo, bs = gla.summation_bound(r, k, v, g, chunk=chunk, **kw)
        ratio_o, ratio_s = over(o, o_r, bo), over(s, s_r, bs)
        ms = time_ms(lambda: gla.chunked_gla(r, k, v, g, chunk=chunk, **kw),
                     reps=5)
        rec_ms = time_ms(lambda: gla.reference_recurrence(r, k, v, g, **kw),
                         reps=2, warmup=1)
    name = model.cfg.name
    check(bool(torch.isfinite(o).all()) and bool(torch.isfinite(s).all()),
          f"{name} chunked_gla: finite")
    check(ratio_o <= 1.0 and ratio_s <= 1.0,
          f"{name} chunked_gla vs reference_recurrence: |d| / bound "
          f"{ratio_o:.3g} (outputs), {ratio_s:.3g} (state)")
    out = dict(shape=dict(r=list(r.shape), v=list(v.shape), g=list(g.shape)),
               chunk=chunk, inclusive=inclusive, bonus=u is not None,
               max_chunk_log_decay_sum=big_g,
               max_over_bound_o=ratio_o, max_over_bound_state=ratio_s,
               bound="(c + Dk + 8) * 2^-24 * A + 2 (c + 1) * 2^-24 * A_G",
               chunked_ms=ms, recurrence_ms=rec_ms)
    print(f"[gla] {name} {list(r.shape)} -> {list(v.shape)}: largest G "
          f"(sum |g| over a chunk) {big_g:.4g}; chunked vs recurrence "
          f"|d| / bound {ratio_o:.3g} / {ratio_s:.3g} (o / state); chunked "
          f"{ms:.3f} ms, stepped {rec_ms:.1f} ms")
    return out


def recurrent_serve_phase(kern, zero, record, profile):
    """The hybrid (hymba-1.5b) and ssm (rwkv6-1.6b) families at full width,
    bf16, random weights from seed 0: ``serve_path`` (generate at B = 4, a
    128-token prompt, 32 greedy tokens, zero launches; the bf16 prefill
    gap recorded and ``prefill_vs_decode_f32`` checked; decode ms, tok/s,
    the byte bound with the recurrent state, peak memory), ``Model.prefill`` at 2048 tokens
    (zero launches, finite, timed, peak memory), the parameter count of the
    tree beside ``cfg.n_params()``, ``gla_against_recurrence`` and, with
    ``profile``, 3 decode steps under the profiler."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.tree import tree_leaves
    t0 = time.perf_counter()
    for arch in RECURRENT_ARCHS:
        torch.cuda.empty_cache()
        model = Model(get_config(arch), device="cuda")
        params = model.init(0)
        key = "serve_" + arch
        out = serve_path(kern, zero, model, params, record, key)
        out["n_params_tree"] = sum(t.numel() for t in tree_leaves(params))
        prompt = torch.as_tensor(np.random.default_rng(4).integers(
            0, model.cfg.vocab_size, (SERVE_BATCH, LONG_PROMPT)),
            device="cuda")
        torch.cuda.reset_peak_memory_stats()
        pf, _, ms = timed_prefill(kern, zero, model, params, prompt)
        check(tuple(pf.shape) == (SERVE_BATCH, model.v_pad)
              and bool(torch.isfinite(pf).all()),
              f"{arch} prefill at {LONG_PROMPT}: finite logits")
        out.update(prefill_forward_ms_long=ms, long_prompt=LONG_PROMPT,
                   peak_gb_prefill_long=torch.cuda.max_memory_allocated()
                   / 1e9)
        out["gla"] = gla_against_recurrence(model, params)
        print(f"[{key}] n_params {out['n_params']} (config), "
              f"{out['n_params_tree']} (tree); Model.prefill at "
              f"{LONG_PROMPT} tokens {ms:.1f} ms, peak "
              f"{out['peak_gb_prefill_long']:.2f} GB")
        if profile:
            out["profile_decode"] = profile_decode(model, params)
            print(f"[profile decode {arch}]",
                  json.dumps(out["profile_decode"]))
        del model, params, pf
    torch.cuda.empty_cache()
    record["recurrent_serve_phase_s"] = time.perf_counter() - t0
    print(f"[recurrent serve phase] {record['recurrent_serve_phase_s']:.1f} s")


# ---------------------------------------------- recurrent training phase
REMAT_MODES = ("none", "full", "dots")


def remat_modes_bit_for_bit(arch, params, batch, cfg=None):
    """One batch's loss and every gradient under ``remat`` "none", "full"
    and "dots": bit for bit equal (a recompute runs the same kernels on the
    same shapes), each mode's peak memory and wall (ending in a
    synchronize). The first mode's gradients stay on the card for the
    comparison; each later mode's are freed once compared. ``cfg``: the
    model's config (the arch's full config unless given)."""
    import dataclasses
    import gc
    from repro_torch.configs import get_config
    from repro_torch.dist.grad_sync import loss_and_grads
    from repro_torch.models import Model
    out, first = {}, None
    for mode in REMAT_MODES:
        model = Model(dataclasses.replace(cfg or get_config(arch),
                                          remat=mode), device="cuda")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _, grads = loss_and_grads(model.loss_fn, params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[mode] = dict(loss=float(loss), wall_s=wall,
                         peak_memory_bytes=torch.cuda.max_memory_allocated())
        if first is None:
            first = (loss, grads)
        else:
            check(bits_equal(loss, first[0]) and all(
                a.dtype == b.dtype and same_bits(a, b)
                for a, b in zip(grads, first[1])),
                f"{arch}: loss and every gradient under remat {mode!r} "
                f"bit for bit those under {REMAT_MODES[0]!r}")
        del grads
    del first
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[remat] {arch}: loss and gradients bit for bit under "
          f"{', '.join(REMAT_MODES)}; peak GB "
          f"{ {m: round(v['peak_memory_bytes'] / 1e9, 2) for m, v in out.items()} }"
          f", wall s { {m: round(v['wall_s'], 3) for m, v in out.items()} }")
    return out


def hymba_at_depth(kern, zero, arch, batch, leaves, add):
    """hymba's compressed pods and ``fl_train`` at the depth ``at_depth``
    sets (``CUT_LAYERS``, full width): ``train --compressed-pods 4
    --wire-cr 0.05``, 4 steps (each merge kernel once per leaf of at least
    4096 elements a step, EF residuals nonzero there, the merge's ms a
    step, one step's pod gradients through both merge routes), then
    ``fl_train`` at its defaults (bcrs_opwa, C = 8, 4 rounds) through the
    round engine and through the mesh scan, bit for bit. Returns the
    records by run."""
    import gc
    import repro_torch.configs as configs
    from repro_torch.fed import engine as eng
    from repro_torch.launch import fl_train as fl
    from repro_torch.models import Model
    out = {}
    model = Model(configs.get_config(arch), device="cuda")
    label = f"{arch} bcrs_opwa {TRAIN_PODS} pods"
    res, run, counts = train_run(kern, zero, label, None, arch=arch,
                                 steps=TRAIN_STEPS,
                                 compressed_pods=TRAIN_PODS)
    add(counts)
    check_ef(label, res["opt_state"]["ef"], embed_kept_whole=True)
    train_routes(model, res["params"], res["opt_state"]["ef"], batch,
                 res["pod_crs"], run)
    run["n_layers"] = model.cfg.n_layers
    out[f"train {TRAIN_PODS} pods"] = run
    del res, model
    gc.collect()
    torch.cuda.empty_cache()

    cfg = fl.FLTrainConfig(arch=arch, engine="round", device="cuda",
                           rounds=FL_ROUNDS)
    label = f"{arch} bcrs_opwa C={cfg.clients}"
    run, res, counts = fl_round_run(kern, zero, fl, cfg, leaves, label)
    add(counts)
    n_params = sum(p.numel() for _, p in eng.tree_items(res["params"]))
    ref = dict(executed_rounds=res["executed_rounds"], losses=res["losses"],
               params=host_copy(res["params"]), residuals=None)
    del res
    gc.collect()
    torch.cuda.empty_cache()
    scan, counts = scan_against_round(kern, zero, fl, cfg, ref, leaves,
                                      n_params, label)
    add(counts)
    run.update(scan=scan, n_layers=configs.get_config(arch).n_layers)
    out["fl_train"] = run
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    return out


def recurrent_train_phase(kern, zero, record):
    """Training the hybrid (hymba-1.5b) and ssm (rwkv6-1.6b) families at
    full width on the card (bf16, seed 0, the config's ``remat``,
    "full"; ``launch.train``'s CLI defaults: sgd, lr 1e-2, B = 8, S = 256,
    two GLA chunks). For each family: (1) one batch's loss and gradient
    twice, bit for bit (``grad_reproducible``; rwkv6's unread
    ``final_norm_b`` gets zeros); (2) the loss and every gradient under
    ``remat`` "none", "full" and "dots", bit for bit, with each mode's
    peak memory (``remat_modes_bit_for_bit``); (3) ``train.run``, 4 steps,
    counts set to 0 just before and read just after: finite losses, no
    merge launch, the wall a step (first apart), peak memory, and one more
    step under the profiler (device idle share). hymba only, at
    ``CUT_LAYERS`` of its 32 layers (full width; ``hymba_at_depth``): (4)
    ``train --compressed-pods 4 --wire-cr 0.05``, 4 steps: each merge kernel
    launched once per leaf of at least 4096 elements a step, EF residuals
    nonzero on those leaves, the merge's ms a step, then one step's pod
    gradients through both routes of ``compress_merge_leaf``
    (``train_routes``: thresholds, masks, ks and residuals bitwise, agg
    within its bound); (5) ``fl_train`` at the CLI's defaults (bcrs_opwa,
    C = 8, 4 rounds) through the round engine (``fl_round_run``: each
    kernel launched leaves x rounds, wall, peak memory, the merge's
    share, the losses per round) and through the mesh scan, whose one
    captured CUDA graph a round holds the checkpointed backward
    (``scan_against_round``: bit for bit against the round engine).
    Returns the launches per kernel over the driven runs."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.dist import grad_sync as gs
    from repro_torch.fed import engine as eng
    from repro_torch.launch import train as tr
    from repro_torch.models import Model
    from repro_torch.optim import make_optimizer
    t_phase = time.perf_counter()
    total = dict(zero)
    out = {}

    def add(counts):
        for name, n in counts.items():
            total[name] += n

    for arch in RECURRENT_ARCHS:
        t_arch = time.perf_counter()
        cfg0 = tr.TrainConfig(arch=arch, device="cuda")
        model = Model(get_config(arch), device="cuda")
        params = model.init(cfg0.seed)
        items = eng.tree_items(params)
        n_params = sum(p.numel() for _, p in items)
        big = sum(1 for _, p in items if p.numel() >= TRAIN_MIN_LEAF)
        batch = tr._batch(cfg0, model.cfg,
                          np.random.default_rng(1), "cuda")
        rec = dict(remat=model.cfg.remat, parameters=n_params,
                   leaves=len(items), compressed_leaves=big)
        rec["loss_reproducible"] = grad_reproducible(model, params, batch)
        rec["remat_modes"] = remat_modes_bit_for_bit(arch, params, batch)
        del params, items
        gc.collect()
        torch.cuda.empty_cache()

        res, run, counts = train_run(kern, zero, f"{arch} dense sgd", 0,
                                     arch=arch, steps=TRAIN_STEPS)
        add(counts)
        step = gs.make_train_step(model, make_optimizer("sgd", cfg0.lr))
        _, wall, by_name = device_profile(
            lambda: step(res["params"], (), batch))
        run["profile"] = busy_record(wall, by_name)
        print(f"[profile train step] {arch}: {json.dumps(run['profile'])}")
        rec["train dense sgd"] = run
        del res, step
        gc.collect()
        torch.cuda.empty_cache()

        if arch == "hymba-1.5b":
            with at_depth(CUT_LAYERS):
                rec.update(hymba_at_depth(kern, zero, arch, batch,
                                          rec["leaves"], add))
        rec["seconds"] = time.perf_counter() - t_arch
        out[arch] = rec
        del model, batch
        gc.collect()
        torch.cuda.empty_cache()
    record["recurrent_train_phase"] = dict(
        runs=out, seconds=time.perf_counter() - t_phase,
        launches={k: v for k, v in total.items() if v})
    print(f"[recurrent train phase] {time.perf_counter() - t_phase:.1f} s, "
          f"launches {record['recurrent_train_phase']['launches']}")
    return total


# --------------------------------------------- cross-attention phase
CROSS_ARCHS = ("whisper-medium", "llama-3.2-vision-11b")
CROSS_FAMILIES = ("encdec", "vlm")
#: vlm's cross gates for every check: at the init's zeros (tanh(0) = 0)
#: each cross block is the identity and its ``xattn`` and MLP get no
#: gradient, so a check that kept them would pass whatever the
#: cross-attention computed (tests/test_torch_cross.py sets the same)
VLM_GATES = {"gate_attn": 0.7, "gate_mlp": -0.4}
WHISPER_FRAMES = 1500         # 30 s of audio: the encoder's positions
WHISPER_TOKENS = 448          # whisper's max_target_len
VLM_PREFILL = 2048            # the vlm's prefill, over its 1024 patches
#: the f32 prefill-vs-decode check's depth: whisper whole, the vlm at 2 of
#: its 8 groups (8 self and 2 cross blocks, full width)
CROSS_F32_LAYERS = {"encdec": None, "vlm": 8}
CROSS32_PROMPT, CROSS32_BATCH = 128, 2
#: --compressed-pods: whisper at full depth, the vlm at 2 of 8 groups (its
#: 9.78e9 parameters' pod gradients and f32 EF residuals would not fit)
CROSS_PODS = {"whisper-medium": (4, CUT_LAYERS),
              "llama-3.2-vision-11b": (2, 8)}
#: the depth each family serves and trains at, cut for the script's time:
#: whisper whole, the vlm at 2 of its 8 groups (8 self and 2 cross blocks)
CROSS_DEPTH = {"whisper-medium": None, "llama-3.2-vision-11b": 8}


def cross_memory(cfg, batch: int, seed: int, frames: int = WHISPER_FRAMES):
    """Seeded N(0, 1) f32 frames [B, frames, d] (encdec) or patches [B,
    n_patches, d_vision] (vlm) on the card, as ``launch.train`` draws
    them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if cfg.family == "encdec":
        return {"frames": torch.randn(batch, frames, cfg.d_model,
                                      generator=g, device="cuda")}
    v = cfg.vision
    return {"patches": torch.randn(batch, v.n_patches, v.d_vision,
                                   generator=g, device="cuda")}


def set_gates(params):
    """vlm's every gate set to ``VLM_GATES`` in place; others untouched."""
    if "groups" in params:
        for name, value in VLM_GATES.items():
            params["groups"]["cross"][name].fill_(value)
    return params


@contextlib.contextmanager
def gated_init():
    """``Model.init`` (as ``launch.train`` calls it) with ``set_gates``."""
    from repro_torch.models import transformer as tfm
    init = tfm.Model.init
    tfm.Model.init = lambda self, seed: set_gates(init(self, seed))
    try:
        yield
    finally:
        tfm.Model.init = init


def fill_cross_caches(model, params, cache, memory):
    """The cross caches a request would need, filled here (nothing in the
    package fills them, nor in the reference): whisper's ``ck`` / ``cv``
    of decoder layer i from ``_encode``'s memory through that layer's
    ``xattn.wk`` / ``wv``, the vlm's of group g from the projected
    patches through group g's. Returns the cache with ``ck`` / ``cv``
    replaced by ``[L or G, B, S_mem, Hkv, D]`` tensors."""
    cfg = model.cfg
    with torch.no_grad():
        if cfg.family == "encdec":
            mem = model._encode(params, memory["frames"])
            xattn = params["layers"]["xattn"]
        else:
            mem = memory["patches"].to(model.dtype) @ params["vis_proj"]
            xattn = params["groups"]["cross"]["xattn"]
        b, s = mem.shape[:2]
        shape = (b, s, cfg.n_kv_heads, cfg.resolved_head_dim)
        kv = {name: torch.stack([(mem @ w).reshape(shape)
                                 for w in xattn[name]]).to(cache["k"].dtype)
              for name in ("wk", "wv")}
    return dict(cache, ck=kv["wk"], cv=kv["wv"])


def cross_prefill_f32(kern, zero, model, params):
    """``Model.prefill`` against the stepped decode in f32 at full width:
    the bf16 params upcast (the same weights, exactly) in an f32 model
    (the frames or patches are cast to the model's dtype), an f32 cache whose
    cross caches ``fill_cross_caches`` fills from the same frames or
    patches, a ``CROSS32_PROMPT``-token prompt at B = ``CROSS32_BATCH``,
    the launch counters reset just before and read just after each (zero);
    the last prompt token's logits within ``logit_tolerance_f32`` (R =
    ``LOGIT_ROUNDINGS``, L the decoder-side blocks, K the longest
    contraction), argmax equal where the top-2 margin exceeds 2 * tol. The
    planted fault is the served decode, whose cross caches stay zero (a
    zeroed memory): it must fail the same bound."""
    import dataclasses
    from repro_torch.launch.serve import generate
    from repro_torch.models import Model
    from repro_torch.tree import tree_from_items, tree_items
    # frames and patches are cast to the model's dtype: an f32 model
    model = Model(dataclasses.replace(model.cfg, dtype="float32"),
                  device="cuda")
    cfg = model.cfg
    blocks = cfg.n_layers + (cfg.vision.n_cross_layers
                             if cfg.family == "vlm" else 0)
    p32 = tree_from_items([(k, t.float() if t.is_floating_point() else t)
                           for k, t in tree_items(params)])
    prompt = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (CROSS32_BATCH, CROSS32_PROMPT)), device="cuda")
    memory = cross_memory(cfg, CROSS32_BATCH, 6)
    res, counts = drive(kern, lambda: generate(model, p32, prompt, 1,
                                               torch.float32))
    check_counts(counts, zero, f"{cfg.name} f32 decode, zero cross caches")

    def fwd():
        with torch.no_grad():
            return model.prefill(p32, dict(memory, tokens=prompt))[0]

    pf, counts = drive(kern, fwd)
    check_counts(counts, zero, f"{cfg.name} f32 prefill")
    cache = fill_cross_caches(
        model, p32, model.init_cache(CROSS32_BATCH, CROSS32_PROMPT,
                                     torch.float32), memory)
    mem_len = cache["ck"].shape[2]

    def stepped():
        with torch.no_grad():
            for pos in range(CROSS32_PROMPT):
                logits, _ = model.decode_step(p32, cache, prompt[:, pos],
                                              pos)
            return logits

    dec, counts = drive(kern, stepped)
    check_counts(counts, zero, f"{cfg.name} f32 decode, filled cross caches")
    del p32, cache, memory
    dec = dec[:, :cfg.vocab_size]
    pre = pf[:, :cfg.vocab_size]
    served = res["prompt_logits"][:, :cfg.vocab_size]
    check(dec.dtype == pre.dtype == torch.float32
          and bool(torch.isfinite(dec).all())
          and bool(torch.isfinite(pre).all()),
          f"{cfg.name} f32 prefill and decode: finite f32 logits")
    r = LOGIT_ROUNDINGS[cfg.family]
    k = max(cfg.d_ff, mem_len, CROSS32_PROMPT)
    tol = logit_tolerance_f32(blocks, dec, r, k)
    diff = float((pre - dec).abs().max())
    check(diff <= tol, f"{cfg.name} f32 prefill vs decode over filled cross "
                       f"caches: max |d| {diff:.4g} > {tol:.4g}")
    fault = float((pre - served).abs().max())
    check(fault > tol, f"{cfg.name}: the served decode (zero cross caches) "
                       f"fails the bound: max |d| {fault:.4g} <= {tol:.4g}")
    top2 = dec.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    same = dec.argmax(-1) == pre.argmax(-1)
    check(bool(same[margin > 2 * tol].all()),
          f"{cfg.name} f32 prefill vs decode: argmax agrees where the top-2 "
          "margin exceeds 2 * tol")
    rms = float(dec.pow(2).mean().sqrt())
    out = dict(batch=CROSS32_BATCH, prompt=CROSS32_PROMPT, memory=mem_len,
               blocks=blocks, max_abs=diff, tol=tol, over_tol=diff / tol,
               zero_memory_max_abs=fault, zero_memory_over_tol=fault / tol,
               logits_rms=rms,
               formula=f"6 * 2^-24 * sqrt(L * {r} * {k}) * rms(logits)",
               argmax_agree=same.tolist(), top2_margin=margin.tolist())
    print(f"[f32 prefill vs decode] {cfg.name} at {blocks} blocks "
          f"B={CROSS32_BATCH} S={CROSS32_PROMPT} memory {mem_len}: max |d| "
          f"{diff:.4g} = {diff / tol:.3g} of tol {tol:.4g} "
          f"({out['formula']}; rms {rms:.4g}); zero cross caches "
          f"{fault / tol:.3g} of it")
    return out


def cross_serve(kern, zero, arch, record, profile=True):
    """One cross family at full width, bf16, seed 0 (vlm's gates set):
    ``serve_path`` (generate at B = 4, 128 / 32, zero launches, decode ms
    a step beside its byte bound, peak memory, ``cross_prefill_f32``),
    ``Model.prefill`` at the model's own shape (whisper: 1500 frames and
    448 tokens; the vlm: 2048 tokens over its 1024 patches) and 3 decode
    steps under the profiler (launches a step, idle share)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.tree import tree_leaves
    model = Model(get_config(arch), device="cuda")
    params = set_gates(model.init(0))
    cfg = model.cfg
    key = "serve_" + arch
    out = serve_path(kern, zero, model, params, record, key)
    out["n_params_tree"] = sum(t.numel() for t in tree_leaves(params))
    seq = WHISPER_TOKENS if cfg.family == "encdec" else VLM_PREFILL
    prompt = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (SERVE_BATCH, seq)), device="cuda")
    memory = cross_memory(cfg, SERVE_BATCH, 7)
    torch.cuda.reset_peak_memory_stats()
    pf, _, ms = timed_prefill(kern, zero, model, params, prompt, memory)
    check(tuple(pf.shape) == (SERVE_BATCH, model.v_pad)
          and bool(torch.isfinite(pf).all()),
          f"{arch} prefill at {seq} tokens: finite logits")
    mem_len = next(iter(memory.values())).shape[1]
    out.update(prefill_forward_ms_own_shape=ms, own_shape_tokens=seq,
               own_shape_memory=mem_len,
               peak_gb_prefill_own_shape=torch.cuda.max_memory_allocated()
               / 1e9)
    del memory, pf
    if profile:
        out["profile_decode"] = profile_decode(model, params)
        print(f"[profile decode {arch}]", json.dumps(out["profile_decode"]))
    print(f"[{key}] n_params {out['n_params']} (config), "
          f"{out['n_params_tree']} (tree); Model.prefill at B={SERVE_BATCH} "
          f"x {seq} tokens over {mem_len} "
          f"{'frames' if cfg.encdec else 'patches'} {ms:.1f} ms, peak "
          f"{out['peak_gb_prefill_own_shape']:.2f} GB")
    del model, params
    torch.cuda.empty_cache()
    return out


def cross_train(kern, zero, arch, record):
    """Training one cross family at full width (bf16, seed 0, remat
    "full", ``launch.train``'s CLI defaults: sgd, lr 1e-2, B = 8, S = 256;
    vlm's gates set through ``gated_init``). whisper: one batch's gradient
    twice bit for bit (``grad_reproducible``) and under the three remat
    modes (``remat_modes_bit_for_bit``, each mode's peak). Both: dense sgd
    4 steps (``train_run``: no merge launch, wall a step, peak memory) and
    one more step under the profiler; ``--compressed-pods`` (whisper 4
    pods at full depth, the vlm 2 at 2 of 8 groups) 4 steps: each merge
    kernel once per leaf of at least 4096 elements a step, EF residuals
    nonzero there, the merge's ms a step, then one step's pod gradients
    through both merge routes and through ``threshold_find`` /
    ``fused_merge`` against their twins, bit for bit, leaf by leaf
    (``train_routes(twins=True)``). Returns the launches per kernel."""
    import gc
    import repro_torch.configs as configs
    from repro_torch.configs import get_config
    from repro_torch.dist import grad_sync as gs
    from repro_torch.launch import train as tr
    from repro_torch.models import Model
    from repro_torch.optim import make_optimizer
    total = dict(zero)
    rec = {}
    cfg0 = tr.TrainConfig(arch=arch, device="cuda")
    with gated_init():
        if arch == "whisper-medium":
            model = Model(get_config(arch), device="cuda")
            params = model.init(cfg0.seed)
            batch = tr._batch(cfg0, model.cfg, np.random.default_rng(1),
                              "cuda")
            rec["loss_reproducible"] = grad_reproducible(model, params,
                                                         batch)
            rec["remat_modes"] = remat_modes_bit_for_bit(arch, params, batch)
            del model, params, batch
            gc.collect()
            torch.cuda.empty_cache()
        res, run, counts = train_run(kern, zero, f"{arch} dense sgd", 0,
                                     arch=arch, steps=TRAIN_STEPS)
        for name, n in counts.items():
            total[name] += n
        model = Model(get_config(arch), device="cuda")
        batch = tr._batch(cfg0, model.cfg, np.random.default_rng(1), "cuda")
        step = gs.make_train_step(model, make_optimizer("sgd", cfg0.lr))
        def one_step():
            # its outputs (the vlm's new params: 19.6 GB) dropped at once
            step(res["params"], (), batch)

        _, wall, by_name = device_profile(one_step)
        run["profile"] = busy_record(wall, by_name)
        print(f"[profile train step] {arch}: {json.dumps(run['profile'])}")
        rec["train dense sgd"] = run
        del res, step, model, batch
        gc.collect()
        torch.cuda.empty_cache()

        pods, depth = CROSS_PODS[arch]
        with at_depth(depth):
            model = Model(configs.get_config(arch), device="cuda")
            label = (f"{arch} bcrs_opwa {pods} pods"
                     + (f" at {depth} self layers" if depth else ""))
            res, run, counts = train_run(kern, zero, label, None, arch=arch,
                                         steps=TRAIN_STEPS,
                                         compressed_pods=pods)
            for name, n in counts.items():
                total[name] += n
            check_ef(label, res["opt_state"]["ef"], embed_kept_whole=True)
            batch = tr._batch(cfg0, model.cfg, np.random.default_rng(1),
                              "cuda")
            train_routes(model, res["params"], res["opt_state"]["ef"],
                         batch, res["pod_crs"], run, pods=pods, twins=True)
            run["depth"] = model.cfg.n_layers
            rec[f"train {pods} pods"] = run
            del res, batch, model
            gc.collect()
            torch.cuda.empty_cache()
    return rec, total


#: what may stay allocated between the two cross families: cuBLAS
#: workspaces and cached constants, far below one layer of either model
RESIDENT_LIMIT = 256 * 2 ** 20


def resident_on_card():
    """Bytes still allocated on the card after a collection (cuBLAS
    workspaces released first) and the five largest CUDA tensors that
    Python still reaches, as (shape, dtype, MiB)."""
    import gc
    gc.collect()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()
    live = [(tuple(t.shape), str(t.dtype),
             t.numel() * t.element_size() / 2 ** 20)
            for t in gc.get_objects() if torch.is_tensor(t) and t.is_cuda]
    return (torch.cuda.memory_allocated(),
            sorted(live, key=lambda t: -t[2])[:5])


def cross_phase(kern, zero, record):
    """The encdec (whisper-medium) and vlm (llama-3.2-vision-11b) families
    at full width on the card: ``cross_serve`` then ``cross_train`` for
    each; before the vlm runs, nothing of the earlier work is left
    resident (``resident_on_card`` below ``RESIDENT_LIMIT``). Returns the
    launches per kernel over the driven runs."""
    t_phase = time.perf_counter()
    total = dict(zero)
    out = {}
    for arch in CROSS_ARCHS:
        t0 = time.perf_counter()
        resident, largest = resident_on_card()
        if arch != CROSS_ARCHS[0]:
            check(resident < RESIDENT_LIMIT,
                  f"nothing left resident before {arch}: "
                  f"{resident / 2 ** 20:.1f} MiB allocated; largest live "
                  f"tensors {largest}")
        with at_depth(CROSS_DEPTH[arch]):
            serve = cross_serve(kern, zero, arch, record)
            rec, counts = cross_train(kern, zero, arch, record)
        for name, n in counts.items():
            total[name] += n
        rec.update(serve=serve, resident_bytes_before=resident,
                   largest_live_tensors_before=largest,
                   seconds=time.perf_counter() - t0)
        out[arch] = rec
    record["cross_phase"] = dict(
        runs=out, seconds=time.perf_counter() - t_phase,
        launches={k: v for k, v in total.items() if v})
    print(f"[cross phase] {time.perf_counter() - t_phase:.1f} s, launches "
          f"{record['cross_phase']['launches']}")
    return total


# ------------------------------------------------------------- moe phase
MOE_ARCHS = ("deepseek-v3-671b", "kimi-k2-1t-a32b")
#: serving depth: one whole period of each model, every width, every
#: expert and top-8 kept: deepseek's 3 dense layers and 1 of its 58 MoE
#: layers (15.80e9 parameters, 31.6 GB in bf16), kimi's 1 dense layer and
#: 1 of its 60 (19.97e9, 39.9 GB). At full depth they hold 671e9 and
#: 1.03e12 parameters, which no 80 GB card holds (PERF.md §4).
MOE_SERVE_LAYERS = {"deepseek-v3-671b": 4, "kimi-k2-1t-a32b": 2}
MOE_PREFILL = 2048            # Model.prefill at B = 4: 8192 routed tokens
#: the f32 prefill-vs-decode check: B = 1 x 8 tokens, T = 8 at capacity 8
#: (= top-k), so no expert can overflow and no token is dropped, as in the
#: decode (T = B). At random init the attention averages the values over
#: the prefix, so every token's router input shares one direction and a
#: few experts take most tokens: at B = 2 x 32 (capacity 8, a mean load
#: of 2) the prefill dropped 91 of 512 (token, slot) pairs, at 4 x 2048
#: 11,637 of 65,536 (PERF.md §6); only T <= k rules it out.
MOE32_PROMPT, MOE32_BATCH = 8, 1
#: f32 sites a block at which prefill and the stepped decode sum in other
#: orders (a GEMM against a GEMV, the expanded MLA against the absorbed
#: one), counted as ``LOGIT32_PROMPT``'s comment says: MLA 12 (ln1's mean,
#: wq_a, q_norm's mean, wq_b, wkv_a, kv_norm's mean, the nope scores (q .
#: c wk_b against q wk_b^T . c), the rope scores, the softmax's sum, the
#: weighted sum, the wv_b fold, wo) and the MoE 9 (ln2's mean, the
#: router, the experts' gate, up and down, the combine, the shared
#: expert's gate, up and down). K, the longest contraction a block, is
#: the dense blocks' d_ff = 18432 (wo's is H * dv = 16384, an expert's
#: down d_e = 2048, the latent 512).
MOE_F32_R = 21
#: one full-width MoE layer's gradient: T = 8 x 256 tokens (capacity 80)
MOE_LAYER_BATCH = (8, 256)
MOE_TRAIN_PODS, MOE_WIRE_CR = 2, 0.1
#: the margin check's router rounding, in the form of the logit bounds:
#: Z standard deviations of a d-term f32 dot product's rounding, whose
#: partial sums make it 2^-24 * sqrt(d) * ||x * w_e||_2 in rms. The
#: worst case, d * 2^-24 * sum_i |x_i w_ie|, is ~0.02 at d = 7168, a
#: third of the mean gap between the 8th and 9th of 256 standard normal
#: logits (~0.055): it would call a near-tie every third token, fault or
#: not. It is printed beside.
ROUTER_Z = 6.0


@contextlib.contextmanager
def moe_spy(fn):
    """``moe.apply_moe`` calling ``fn(params, x, mo)`` on each MoE layer's
    own input first (``apply_moe`` itself unchanged)."""
    from repro_torch.models import moe
    real = moe.apply_moe

    def spy(p, x, **kw):
        fn(p, x, kw["mo"])
        return real(p, x, **kw)
    moe.apply_moe = spy
    try:
        yield
    finally:
        moe.apply_moe = real


def upcast_in_place(tree):
    """Every floating leaf of a nested dict cast to f32 in place, one leaf
    at a time, each bf16 leaf freed as its f32 copy replaces it."""
    for k in list(tree):
        if isinstance(tree[k], dict):
            upcast_in_place(tree[k])
        elif tree[k].is_floating_point() and tree[k].dtype != torch.float32:
            tree[k] = tree[k].float()
            torch.cuda.empty_cache()


def moe_serve(kern, zero, arch, record):
    """One moe model at full width, its depth cut to ``MOE_SERVE_LAYERS``
    (bf16, seed 0): ``serve_path`` (generate at B = 4, 128 / 32, zero
    launches, decode ms a step beside its byte bound, which reads every
    expert, peak memory, the bf16 prefill-vs-decode gap recorded), then
    ``Model.prefill`` at 4 x 2048 timed, its dropped (token, slot) pairs
    counted by ``moe.dropped_tokens`` on each MoE layer's own input in an
    untimed run, and 3 decode steps under the profiler (launches a step,
    idle share). Returns (model, params, record)."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.models import Model, moe
    from repro_torch.tree import tree_leaves
    cfg = cut_config(get_config(arch), MOE_SERVE_LAYERS[arch])
    model = Model(cfg, device="cuda")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(0)
    init_peak = torch.cuda.max_memory_allocated()
    key = "serve_" + arch
    out = serve_path(kern, zero, model, params, record, key)
    out.update(n_layers=cfg.n_layers,
               first_dense_layers=cfg.moe.first_dense_layers,
               n_params_tree=sum(t.numel() for t in tree_leaves(params)),
               params_bytes=nbytes(params), peak_gb_init=init_peak / 1e9)
    prompt = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (SERVE_BATCH, MOE_PREFILL)), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    pf, _, ms = timed_prefill(kern, zero, model, params, prompt)
    peak = torch.cuda.max_memory_allocated()
    check(tuple(pf.shape) == (SERVE_BATCH, model.v_pad)
          and bool(torch.isfinite(pf).all()),
          f"{arch} prefill at {MOE_PREFILL} tokens: finite logits")
    del pf
    drops = []
    with moe_spy(lambda p, x, mo: drops.append(moe.dropped_tokens(
            p, x, mo))), torch.no_grad():
        model.prefill(params, {"tokens": prompt})
    t = SERVE_BATCH * MOE_PREFILL
    out.update(prefill_forward_ms_own_shape=ms, own_shape_tokens=MOE_PREFILL,
               peak_gb_prefill_own_shape=peak / 1e9,
               prefill_capacity=moe.capacity(cfg.moe, t),
               prefill_routed_slots=t * cfg.moe.top_k,
               prefill_dropped_per_moe_layer=drops)
    print(f"[{key}] {cfg.n_layers} of {get_config(arch).n_layers} layers "
          f"({cfg.moe.first_dense_layers} dense), {out['n_params_tree']} "
          f"parameters, {out['params_bytes'] / 1e9:.2f} GB; Model.prefill "
          f"at B={SERVE_BATCH} x {MOE_PREFILL} {ms:.1f} ms, peak "
          f"{peak / 1e9:.2f} GB; dropped {drops} of {t * cfg.moe.top_k} "
          f"(token, slot) pairs at capacity {out['prefill_capacity']}")
    out["profile_decode"] = profile_decode(model, params)
    print(f"[profile decode {arch}]", json.dumps(out["profile_decode"]))
    return model, params, out


def routing_margins(pre, dec, k):
    """Each MoE layer's routing on the prefill's input against the stepped
    decode's (both f32, [B, S, d]): the expert sets equal for every token
    (``moe.route`` on each), and every token's k-th logit (prefill's, in
    f64) above its (k+1)-th by more than twice what can move a logit
    between the two paths: the inputs' difference through the router,
    exactly, plus each side's f32 rounding, ``ROUTER_Z * 2^-24 * sqrt(d)
    * ||x * w_e||_2``, at its largest over the experts. Returns (the
    smallest margin, its smallest ratio to that bound, the smallest ratio
    to the worst-case rounding ``d * 2^-24 * sum_i |x_i w_ie|``)."""
    from repro_torch.models import moe
    small, ratio, worst = math.inf, math.inf, math.inf
    for (p, xp, mo), xd in zip(pre, dec):
        d = xp.shape[-1]
        a, b = xp.reshape(-1, d), xd.reshape(-1, d)
        sets = [torch.sort(moe.route(p, x, mo)[2], dim=-1).values
                for x in (a, b)]
        check(torch.equal(*sets), "moe: prefill and decode route every "
              "token to the same experts")
        w = p["router"].double()
        top = (a.double() @ w).topk(k + 1, dim=-1).values
        margin = top[:, k - 1] - top[:, k]
        rnd = ROUTER_Z * 2.0 ** -24 * math.sqrt(d) * (
            a.double() ** 2 @ w ** 2).sqrt()
        move = ((a.double() - b.double()) @ w).abs() + 2 * rnd
        full = d * 2.0 ** -24 * (a.double().abs() @ w.abs())
        small = min(small, float(margin.min()))
        ratio = min(ratio, float((margin / (2 * move.max(-1).values)).min()))
        worst = min(worst, float((margin / (2 * full.max(-1).values)).min()))
    return small, ratio, worst


def moe_prefill_f32(kern, zero, model, params):
    """deepseek's f32 prefill against its stepped decode at the serving
    depth (full width): ``params`` (bf16) upcast in place leaf by leaf,
    the MTP head dropped first (neither path reads it), so that nothing
    else is resident; an f32 model and cache, a ``MOE32_PROMPT``-token
    prompt at B = ``MOE32_BATCH``, the launch counters reset just before
    and read just after each run (zero). Requires: no token dropped in
    the prefill (``moe.dropped_tokens`` on its MoE layer's input); the
    same experts on both paths for every token, each top-8 margin above
    twice what can move a logit between them (``routing_margins``); the
    last prompt token's logits within ``logit_tolerance_f32`` at R =
    ``MOE_F32_R``, K = d_ff. Two planted faults must fail that bound: a
    decode that never stores its rope key, and one whose second routing
    slot goes to the next expert. Empties ``params`` when done."""
    import dataclasses
    from repro_torch.launch.serve import generate
    from repro_torch.models import Model, mla, moe
    torch.cuda.reset_peak_memory_stats()
    params.pop("mtp", None)
    upcast_in_place(params)
    model = Model(dataclasses.replace(model.cfg, dtype="float32"),
                  device="cuda")
    cfg = model.cfg
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers
    prompt = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (MOE32_BATCH, MOE32_PROMPT)), device="cuda")

    def stepped(label):
        res, counts = drive(kern, lambda: generate(model, params, prompt, 1,
                                                   torch.float32))
        check_counts(counts, zero, f"{cfg.name} f32 stepped decode{label}")
        return res["prompt_logits"][:, :cfg.vocab_size]

    steps_in = []
    with moe_spy(lambda p, x, mo: steps_in.append(x)):
        dec = stepped("")
    pre_in, drops = [], []

    def spy(p, x, mo):
        pre_in.append((p, x, mo))
        drops.append(moe.dropped_tokens(p, x, mo))

    def fwd():
        with torch.no_grad():
            return model.prefill(params, {"tokens": prompt})[0]

    with moe_spy(spy):
        pf, counts = drive(kern, fwd)
    check_counts(counts, zero, f"{cfg.name} f32 prefill")
    check(len(pre_in) == n_moe and len(steps_in) == n_moe * MOE32_PROMPT,
          f"{cfg.name}: every MoE layer seen")
    check(drops == [0] * n_moe, f"{cfg.name} f32 prefill drops no token: "
          f"{drops}")
    dec_in = [torch.cat(steps_in[i::n_moe], dim=1) for i in range(n_moe)]
    margin, ratio, worst = routing_margins(pre_in, dec_in, cfg.moe.top_k)
    check(ratio > 1, f"{cfg.name}: every top-{cfg.moe.top_k} margin above "
          f"twice its bound (smallest ratio {ratio:.4g})")
    del steps_in, pre_in, dec_in
    pre = pf[:, :cfg.vocab_size]
    check(dec.dtype == pre.dtype == torch.float32
          and bool(torch.isfinite(dec).all())
          and bool(torch.isfinite(pre).all()),
          f"{cfg.name} f32 prefill and decode: finite f32 logits")
    tol = logit_tolerance_f32(cfg.n_layers, dec, MOE_F32_R, cfg.d_ff)
    diff = float((pre - dec).abs().max())
    check(diff <= tol, f"{cfg.name} f32 prefill vs decode logits: max |d| "
                       f"{diff:.4g} > {tol:.4g}")
    faults = {}
    real_decode, real_route = mla.decode_mla, moe.route

    def no_rope(p, x, cache, pos, **kw):
        out = real_decode(p, x, cache, pos, **kw)
        cache["k_rope"][:, pos] = 0.0
        return out

    def next_expert(p, xt, mo):
        probs, gates, idx = real_route(p, xt, mo)
        idx = idx.clone()
        idx[:, 1] = (idx[:, 1] + 1) % mo.n_experts
        return probs, gates, idx

    for name, mod, attr, fn in (("rope key never stored", mla,
                                 "decode_mla", no_rope),
                                ("second slot to the next expert", moe,
                                 "route", next_expert)):
        real = getattr(mod, attr)
        setattr(mod, attr, fn)
        try:
            bad = stepped(f" ({name})")
        finally:
            setattr(mod, attr, real)
        faults[name] = float((pre - bad).abs().max())
        check(faults[name] > tol, f"{cfg.name}: the planted fault "
              f"({name}) fails the bound: max |d| {faults[name]:.4g} <= "
              f"{tol:.4g}")
    top2 = dec.topk(2, dim=-1).values
    same = dec.argmax(-1) == pre.argmax(-1)
    check(bool(same[top2[:, 0] - top2[:, 1] > 2 * tol].all()),
          f"{cfg.name} f32 prefill vs decode: argmax agrees where the top-2 "
          "margin exceeds 2 * tol")
    rms = float(dec.pow(2).mean().sqrt())
    out = dict(batch=MOE32_BATCH, prompt=MOE32_PROMPT,
               n_layers=cfg.n_layers, dropped=drops,
               capacity=moe.capacity(cfg.moe, MOE32_BATCH * MOE32_PROMPT),
               max_abs=diff, tol=tol, over_tol=diff / tol, logits_rms=rms,
               formula=f"6 * 2^-24 * sqrt(L * {MOE_F32_R} * {cfg.d_ff}) * "
                       "rms(logits)",
               smallest_top8_margin=margin,
               smallest_margin_over_bound=ratio,
               smallest_margin_over_worst_case=worst,
               faults_max_abs=faults,
               faults_over_tol={k: v / tol for k, v in faults.items()},
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    params.clear()
    print(f"[f32 prefill vs decode] {cfg.name} at {cfg.n_layers} layers "
          f"B={MOE32_BATCH} S={MOE32_PROMPT}: dropped {drops}; smallest "
          f"top-{cfg.moe.top_k} margin {margin:.4g} = {ratio:.4g} x its "
          f"bound ({worst:.4g} x the worst case); max |d| {diff:.4g} = "
          f"{diff / tol:.3g} of tol {tol:.4g} ({out['formula']}; rms "
          f"{rms:.4g}); planted faults "
          f"{ {k: round(v, 2) for k, v in out['faults_over_tol'].items()} }"
          f" x tol; peak {out['peak_gb']:.2f} GB")
    return out


def moe_layer_grads():
    """deepseek's MoE layer alone at full width (256 experts of 2048, top-8,
    the shared expert; bf16, seed 0): ``apply_moe`` forward and backward on
    x [8, 256, 7168] (capacity 80) through the loss ``sum(out * c)``, c a
    seeded tensor, twice; every gradient (x, the router, the experts'
    stacks, the shared expert) the same bits both times. The dropped
    pairs, each run's wall and the peak memory (weights, two gradients)."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.tree import tree_items
    cfg = get_config("deepseek-v3-671b")
    mo = cfg.moe
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = moe.init_moe(gen, cfg.d_model, mo, torch.bfloat16)
    b, s = MOE_LAYER_BATCH
    x = torch.randn(b, s, cfg.d_model, generator=gen,
                    device="cuda").to(torch.bfloat16)
    c = torch.randn(b, s, cfg.d_model, generator=gen, device="cuda")
    leaves = [t.requires_grad_(True) for _, t in tree_items(p)] + [
        x.requires_grad_(True)]
    runs, walls = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = moe.apply_moe(p, x, mo=mo, act=cfg.act)
        grads = torch.autograd.grad((out.float() * c).sum(), leaves)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        runs.append(grads)
        del out, grads
    same = all(a.dtype == b_.dtype and same_bits(a, b_)
               for a, b_ in zip(*runs))
    check(same, "deepseek's full-width MoE layer: every gradient the same "
          "bits twice")
    with torch.no_grad():
        drops = moe.dropped_tokens(p, x, mo)
    rec = dict(tokens=b * s, capacity=moe.capacity(mo, b * s),
               routed_slots=b * s * mo.top_k, dropped=drops,
               params=sum(t.numel() for t in leaves[:-1]),
               wall_s=walls, peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del runs, leaves, p, x, c
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[moe layer] deepseek at full width, T={b * s} (capacity "
          f"{rec['capacity']}): gradients bit for bit twice; dropped {drops} "
          f"of {rec['routed_slots']} pairs; wall {[round(w, 4) for w in walls]}"
          f" s; peak {rec['peak_gb']:.2f} GB")
    return rec


def moe_train(kern, zero, arch, add):
    """Training one moe model at ``reduced()`` size on the card (f32,
    seed 0; ``launch.train``'s CLI defaults: sgd, lr 1e-2, B = 8, S =
    256): one batch's gradient twice bit for bit, the loss and every
    gradient bit for bit under the three remat modes; ``launch.train``
    dense sgd and ``--compressed-pods 2 --wire-cr 0.1``, 4 steps each (no
    merge launch dense; each merge kernel once per leaf of at least 4096
    elements a step with pods, EF residuals nonzero there and exactly 0 on
    the dense leaves, the f32 router among them), then one step's pod
    gradients through both merge routes and through ``threshold_find`` /
    ``fused_merge`` against their twins, bit for bit, on every compressed
    leaf (the ``[L, E, d, d_e]`` expert stacks among them)."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.fed import engine as eng
    from repro_torch.launch import train as tr
    from repro_torch.models import Model
    rec = {}
    cfg0 = tr.TrainConfig(arch=arch, reduced=True, device="cuda")
    model = Model(get_config(arch).reduced(), device="cuda")
    params = model.init(cfg0.seed)
    batch = tr._batch(cfg0, model.cfg, np.random.default_rng(1), "cuda")
    items = eng.tree_items(params)
    small = ["/".join(k) for k, p in items if p.numel() < TRAIN_MIN_LEAF]
    rec.update(parameters=sum(p.numel() for _, p in items),
               leaves=len(items), dense_path_leaves=small)
    rec["loss_reproducible"] = grad_reproducible(model, params, batch)
    rec["remat_modes"] = remat_modes_bit_for_bit(arch, params, batch,
                                                 cfg=model.cfg)
    del params, items
    res, run, counts = train_run(kern, zero, f"{arch} reduced dense sgd", 0,
                                 arch=arch, reduced=True, steps=TRAIN_STEPS)
    add(counts)
    rec["train dense sgd"] = run
    del res
    label = (f"{arch} reduced bcrs_opwa {MOE_TRAIN_PODS} pods wire_cr "
             f"{MOE_WIRE_CR}")
    res, run, counts = train_run(kern, zero, label, None, arch=arch,
                                 reduced=True, steps=TRAIN_STEPS,
                                 compressed_pods=MOE_TRAIN_PODS,
                                 wire_cr=MOE_WIRE_CR)
    add(counts)
    check_ef(label, res["opt_state"]["ef"], embed_kept_whole=False)
    train_routes(model, res["params"], res["opt_state"]["ef"], batch,
                 res["pod_crs"], run, pods=MOE_TRAIN_PODS, twins=True,
                 wire=MOE_WIRE_CR)
    rec[f"train {MOE_TRAIN_PODS} pods"] = run
    print(f"[moe train] {arch} reduced: {rec['leaves']} leaves, "
          f"{len(small)} below {TRAIN_MIN_LEAF} elements take the dense "
          f"path: {small}")
    del res, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def moe_fl(kern, zero, add):
    """``fl_train --arch deepseek-v3-671b --reduced`` at its defaults
    (bcrs_opwa, C = 8, 2 local steps, B = 4, S = 128; ``FL_ROUNDS``
    rounds) through the round engine (``fl_round_run``: each kernel
    launched leaves x rounds) and the mesh scan, whose one captured CUDA
    graph a round holds the MoE's routing, dispatch and gather forward and
    backward (``scan_against_round``: bit for bit against the round
    engine)."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.fed import engine as eng
    from repro_torch.launch import fl_train as fl
    from repro_torch.models import Model
    arch = "deepseek-v3-671b"
    items = eng.tree_items(Model(get_config(arch).reduced(),
                                 device="cuda").init(0))
    leaves, n_params = len(items), sum(p.numel() for _, p in items)
    del items
    cfg = fl.FLTrainConfig(arch=arch, reduced=True, engine="round",
                           device="cuda", rounds=FL_ROUNDS)
    label = f"{arch} reduced bcrs_opwa C={cfg.clients}"
    run, res, counts = fl_round_run(kern, zero, fl, cfg, leaves, label)
    add(counts)
    ref = dict(executed_rounds=res["executed_rounds"], losses=res["losses"],
               params=host_copy(res["params"]), residuals=None)
    del res
    gc.collect()
    scan, counts = scan_against_round(kern, zero, fl, cfg, ref, leaves,
                                      n_params, label)
    add(counts)
    run.update(scan=scan, leaves=leaves, parameters=n_params)
    return run


def moe_phase(kern, zero, record):
    """The moe family on the card: deepseek-v3-671b (MLA, MTP) and
    kimi-k2-1t-a32b (GQA) served at full width with their depth cut
    (``moe_serve``), deepseek's f32 prefill against its stepped decode
    (``moe_prefill_f32``) and its MoE layer's full-width gradient twice
    (``moe_layer_grads``), both trained at ``reduced()`` size
    (``moe_train``), and deepseek's ``fl_train`` through both engines
    (``moe_fl``). Nothing of an earlier model is left resident before the
    next (``resident_on_card``). Returns the launches per kernel over the
    driven runs."""
    import gc
    t_phase = time.perf_counter()
    total = dict(zero)
    out = {}

    def add(counts):
        for name, n in counts.items():
            total[name] += n

    for arch in MOE_ARCHS:
        t0 = time.perf_counter()
        resident, largest = resident_on_card()
        check(resident < RESIDENT_LIMIT,
              f"nothing left resident before {arch}: "
              f"{resident / 2 ** 20:.1f} MiB allocated; largest live "
              f"tensors {largest}")
        model, params, serve = moe_serve(kern, zero, arch, record)
        if arch == "deepseek-v3-671b":
            serve["f32"] = moe_prefill_f32(kern, zero, model, params)
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
        rec = dict(serve=serve, resident_bytes_before=resident)
        if arch == "deepseek-v3-671b":
            rec["moe_layer_gradient"] = moe_layer_grads()
        rec.update(moe_train(kern, zero, arch, add))
        rec["seconds"] = time.perf_counter() - t0
        out[arch] = rec
    t0 = time.perf_counter()
    out["fl_train deepseek-v3-671b reduced"] = dict(
        moe_fl(kern, zero, add), seconds=time.perf_counter() - t0)
    record["moe_phase"] = dict(
        runs=out, seconds=time.perf_counter() - t_phase,
        launches={k: v for k, v in total.items() if v})
    print(f"[moe phase] {time.perf_counter() - t_phase:.1f} s, launches "
          f"{record['moe_phase']['launches']}")
    return total


LAYOUT_ARCH = "qwen2.5-32b"
LAYOUT_LAYERS = 2             # of 64, full width: 2.54e9 parameters
LAYOUT_MESH = (2, 2)          # (data, model)
LAYOUT_RANKS = 4
LAYOUT_BATCH = (8, 256)
LAYOUT_LR = 0.01
LAYOUT_WIRE_CR = 0.05         # the train_compressed cell's 2 pods
LAYOUT_CLIENTS_STEPS = 2      # fl_round: 2 clients (the data axis), 2 steps
LAYOUT_FAULT = ("layers", "mlp", "w_up")
LAYOUT_SEED = 0
LAYOUT_DEVICE = "cuda"        # the ranks' device type ("cpu" rehearses)


def max_abs_chunked(a: torch.Tensor, b: torch.Tensor,
                    chunk: int = 1 << 26) -> float:
    """``max_abs`` over flat chunks of ``chunk`` elements, so that a
    full-width leaf's f64 difference is never held whole."""
    a, b = a.reshape(-1), b.reshape(-1)
    return max((max_abs(a[i:i + chunk], b[i:i + chunk])
                for i in range(0, a.numel(), chunk)), default=0.0)


# ------------------------------------------- four ranks sharing one card
# The layout phase runs its four ranks on the one card the run has. NCCL
# refuses two ranks on a device, so they use gloo, whose functional
# collectives crash on CUDA tensors (torch 2.11); and four whole leaves
# with their merges do not fit the card beside each other. This rig
# routes DTensor's collectives through c10d's and merges each leaf on
# rank 0, moving the shares between the ranks' memories by CUDA IPC. A
# deployment gives each rank a card and needs neither.
_SYNC_LIBS: dict = {}


def sync_functional_collectives(device_type: str = "cuda") -> None:
    """Route DTensor's functional collectives on ``device_type`` tensors
    through c10d's synchronous ones, for this process.

    Under gloo torch 2.11's functional collectives
    (``_c10d_functional.all_gather_into_tensor`` and the rest, then
    ``wait_tensor``) crash on CUDA tensors, while
    ``dist.all_gather_into_tensor`` and the other c10d calls on the same
    groups work. DTensor redistributes through the functional ops only,
    so this registers, for ``device_type``, kernels of those ops that call
    the c10d collective and return its finished result (a later
    ``wait_tensor`` finds no pending work). Call it once a process, after
    ``init_process_group``, and only for a gloo group."""
    if device_type in _SYNC_LIBS:
        return
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN, "product": dist.ReduceOp.PRODUCT}

    def red(op):
        """c10d's op for a functional op name; "avg" is a sum, divided
        after (gloo has no average)."""
        op = op.lower()
        if op == "avg":
            return dist.ReduceOp.SUM
        if op not in ops:
            raise NotImplementedError(f"reduce op {op!r} under gloo")
        return ops[op]

    def mean(out, op, n):
        return out.div_(n) if op.lower() == "avg" else out

    def all_gather(x, group_size, group_name):
        out = x.new_empty((group_size * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(),
                                    group=_resolve_process_group(group_name))
        return out

    def reduce_scatter(x, op, group_size, group_name):
        out = x.new_empty((x.shape[0] // group_size,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x.contiguous(), op=red(op),
                                   group=_resolve_process_group(group_name))
        return mean(out, op, group_size)

    def all_reduce(x, op, group_name):
        out = x.clone(memory_format=torch.contiguous_format)
        group = _resolve_process_group(group_name)
        dist.all_reduce(out, op=red(op), group=group)
        return mean(out, op, group.size())

    def all_to_all(x, out_splits, in_splits, group_name):
        rows = sum(out_splits) if len(out_splits) else x.shape[0]
        out = x.new_empty((rows,) + tuple(x.shape[1:]))
        dist.all_to_all_single(out, x.contiguous(),
                               list(out_splits) or None,
                               list(in_splits) or None,
                               group=_resolve_process_group(group_name))
        return out

    def broadcast(x, src, group_name):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.broadcast(out, group_src=src,
                       group=_resolve_process_group(group_name))
        return out

    lib = torch.library.Library("_c10d_functional", "IMPL")
    for name, fn in (("all_gather_into_tensor", all_gather),
                     ("reduce_scatter_tensor", reduce_scatter),
                     ("all_reduce", all_reduce),
                     ("all_to_all_single", all_to_all),
                     ("broadcast", broadcast)):
        lib.impl(name, fn, device_type.upper())
    _SYNC_LIBS[device_type] = lib


def layout_shares(shape, mesh, plc):
    """Every rank's (rank, starts, sizes) of a tensor of ``shape`` laid out
    ``plc`` on the ``DeviceMesh`` ``mesh`` (DTensor's chunking, mesh dims
    in order)."""
    ranks = mesh.mesh.flatten().tolist()
    mshape = tuple(mesh.mesh.shape)
    out = []
    for k, r in enumerate(ranks):
        coord = np.unravel_index(k, mshape)
        starts, sizes = [0] * len(shape), list(shape)
        for i, p in enumerate(plc):
            if p.is_shard():
                d, n = p.dim, mshape[i]
                step = -(-sizes[d] // n)
                lo = min(coord[i] * step, sizes[d])
                starts[d] += lo
                sizes[d] = min(lo + step, sizes[d]) - lo
        out.append((r, starts, sizes))
    return out


def ipc_views(t: torch.Tensor, root: int):
    """Rank ``root``'s views of every rank's ``t`` (CUDA tensors on the
    card the ranks share), opened by CUDA IPC, indexed by rank; None on
    the other ranks. Each rank keeps its ``t`` until ``done_with_views``."""
    import torch.distributed as dist
    from torch.multiprocessing.reductions import reduce_tensor
    me = dist.get_rank()
    handles = [None] * dist.get_world_size()
    dist.all_gather_object(handles, None if me == root or not t.numel()
                           else reduce_tensor(t))
    if me != root:
        return None
    return [t if r == me else (None if h is None else h[0](*h[1]))
            for r, h in enumerate(handles)]


def done_with_views(root: int) -> None:
    """Rank ``root``'s copies finished, then every rank past one barrier
    with the IPC blocks it sent released."""
    import torch.distributed as dist
    if dist.get_rank() == root:
        torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.ipc_collect()


def gather_to_root(x, root: int = 0):
    """A DTensor's whole value on rank ``root`` (None on the others), rank
    ``root`` copying every rank's share straight from its memory on the
    shared card; anything else as it is."""
    from repro_torch.dist import sharding as shd
    if not shd.is_dtensor(x):
        return x
    import torch.distributed as dist
    local = x.to_local().contiguous()
    if not local.is_cuda:             # a rehearsal on CPU ranks
        whole = x.full_tensor()
        return whole if dist.get_rank() == root else None
    views = ipc_views(local, root)
    whole = None
    if dist.get_rank() == root:
        whole = torch.empty(tuple(x.shape), dtype=x.dtype,
                            device=local.device)
        for r, st, sz in layout_shares(x.shape, x.device_mesh,
                                       x.placements):
            if math.prod(sz):
                idx = tuple(slice(a, a + b) for a, b in zip(st, sz))
                whole[idx].copy_(views[r].reshape(sz))
        del views
    done_with_views(root)
    return whole


def scatter_from_root(whole, ref, root: int, dtype):
    """``whole`` (of ``dtype``, on rank ``root``; None elsewhere) laid out
    as the DTensor ``ref``, rank ``root`` copying each rank's share
    straight into its memory on the shared card."""
    import torch.distributed as dist
    from repro_torch.dist import sharding as shd
    shares = layout_shares(ref.shape, ref.device_mesh, ref.placements)
    me = dist.get_rank()
    mine = next(sz for r, _, sz in shares if r == me)
    local = torch.empty(mine, dtype=dtype, device=ref.to_local().device)
    views = ipc_views(local, root)
    if me == root:
        for r, st, sz in shares:
            if math.prod(sz):
                idx = tuple(slice(a, a + b) for a, b in zip(st, sz))
                views[r].copy_(whole[idx].reshape(sz))
        del views
    done_with_views(root)
    return shd.from_local(local, ref.device_mesh, ref.placements, ref.shape)


def merge_on_root(fn, inputs, outs_like):
    """``sharding.leaf_whole`` for ranks that share a card
    (``sharding.set_leaf_whole_hook``): rank 0 gathers the inputs, runs
    ``fn`` alone and scatters each output's shares back; the values are
    the bits every rank's own ``full_tensor()`` and ``fn`` would give."""
    import torch.distributed as dist
    root = 0
    # what each rank's allocator caches is of no use to the others
    torch.cuda.empty_cache()
    wholes = [gather_to_root(x, root) for x in inputs]
    outs = (fn(*wholes) if dist.get_rank() == root
            else [None] * len(outs_like))
    del wholes
    dtypes = (torch.float32, torch.bfloat16, torch.float16, torch.int32)
    res = []
    for r, o in zip(outs_like, outs):
        # 0: no output; else 1 + the index of its dtype
        code = torch.tensor([0 if o is None else 1 + dtypes.index(o.dtype)],
                            dtype=torch.int32)
        dist.broadcast(code, src=root)
        c = int(code)
        res.append(scatter_from_root(o, r, root, dtypes[c - 1])
                   if r is not None and c else None)
    return res


def layout_free() -> None:
    """Drop what Python no longer reaches and give the cached blocks back
    to the card, so that ranks sharing it see each other's frees, and the
    pinned host blocks that gloo's staging of CUDA tensors left cached
    back to the host."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    if not torch.cuda.is_available():
        return
    for name in ("_host_emptyCache", "_accelerator_emptyHostCache"):
        release = getattr(torch._C, name, None)
        if release is not None:
            release()
            break


def tensor_sha256(t: torch.Tensor, chunk: int = 1 << 28) -> str:
    """SHA-256 of a tensor's bytes, copied to the host a chunk at a time."""
    import hashlib
    h = hashlib.sha256()
    flat = t.contiguous().reshape(-1).view(torch.uint8)
    for i in range(0, flat.numel(), chunk):
        h.update(flat[i:i + chunk].cpu().numpy().tobytes())
    return h.hexdigest()


LAYOUT_FREE_SEEN: list = []   # the card's free bytes at rank 0's marks


def layout_say(rank: int, what: str) -> None:
    """Rank 0's progress through the layout phase, flushed as it goes,
    with the card's free memory (all processes on it) at that mark."""
    if rank == 0:
        free = (torch.cuda.mem_get_info()[0] if LAYOUT_DEVICE == "cuda"
                else 0)
        LAYOUT_FREE_SEEN.append(free)
        print(f"[layout rank 0] {time.strftime('%H:%M:%S')} "
              f"({free / 2 ** 30:.2f} GiB free on the card) {what}",
              flush=True)


def layout_config(n_layers: int):
    """qwen2.5-32b at full width cut to ``n_layers`` layers, bf16; the cut
    keeps the full config's FSDP flag (``fsdp_threshold`` 0 when the whole
    model is at or above it), so the cut's params shard as the whole
    model's do."""
    import dataclasses
    from repro_torch.configs import get_config
    full = get_config(LAYOUT_ARCH)
    cut = cut_config(full, n_layers)
    if full.n_params() >= full.fsdp_threshold:
        cut = dataclasses.replace(cut, fsdp_threshold=0)
    return cut


def config_overrides(cfg) -> dict:
    """Every field of ``cfg``, for ``build_cell(overrides=...)``."""
    import dataclasses
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def layout_process_group(rank: int, world: int, init_method=None):
    """Rank ``rank`` of ``world`` on card ``rank % device_count``: NCCL
    when every rank has a card of its own, gloo when ranks share one (NCCL
    refuses two ranks on a device), with DTensor's functional collectives
    routed through c10d's (``sync_functional_collectives``) and every
    leaf merged on rank 0 (``merge_on_root``).
    Returns (backend, device)."""
    import datetime
    import torch.distributed as dist
    from repro_torch.dist import sharding as shd
    if LAYOUT_DEVICE == "cpu":
        n, dev, backend = 0, torch.device("cpu"), "gloo"
    else:
        n = torch.cuda.device_count()
        dev = torch.device("cuda", rank % n)
        torch.cuda.set_device(dev)
        backend = "nccl" if n >= world else "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(minutes=20))
    if backend == "gloo" and dev.type == "cuda":
        sync_functional_collectives("cuda")
        shd.set_leaf_whole_hook(merge_on_root)
    return backend, dev


def layout_batch(cfg, dev, lead=(), seed=11):
    """Seeded tokens [*lead, B, S] (and labels, shifted by one) on ``dev``:
    the same on every rank."""
    b, s = LAYOUT_BATCH
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, tuple(lead) + (b, s + 1),
                         generator=g, dtype=torch.int32)
    return {"tokens": toks[..., :-1].contiguous().to(dev),
            "labels": toks[..., 1:].contiguous().to(dev)}


def upcast_placed(tree):
    """A DTensor tree's floating leaves as f32 DTensors of the same
    layout, each local piece upcast."""
    from repro_torch.dist import sharding as shd
    from repro_torch.tree import tree_from_items, tree_items
    out = []
    for path, x in tree_items(tree):
        if x.is_floating_point() and x.dtype != torch.float32:
            x = shd.from_local(x.to_local().float(), x.device_mesh,
                               x.placements, x.shape)
        out.append((path, x))
    return tree_from_items(out)


def layout_f32_bound(k: int) -> float:
    """The f32 check's bound on ``|sharded - single| / max|g|`` for a
    gradient whose backward sums ``k`` terms in all (the sum of its
    reduction lengths): the root-sum-square ``6 * 2^-24 * sqrt(k)``.

    The two runs add the same terms in other orders: the model axis
    splits each contraction into partial sums added after, the data
    axis splits the batch's, and cuBLAS tiles the shorter local products
    otherwise, so any of the ``k`` adds may round differently. The worst
    case grows linearly in ``k`` (``k * 2^-24``, 1.3% of max|g| at the
    2-layer cut); modelled as independent roundings of either sign, of
    at most 2^-24 of max|g| each, their total grows as ``sqrt(k)``, and
    the bound is six standard deviations of that walk (1.7e-4 of max|g|
    at the cut). A gradient rounded to bf16 (up to 2^-9 relative) or a
    shard lost lands outside it."""
    return 6.0 * 2.0 ** -24 * math.sqrt(k)


def layout_f32_check(rank, dm, cell, cfg, batch):
    """The sharded f32 loss and gradients against the single-process
    port's on the same card: rank 0 runs the whole cut model first (the
    bf16 init upcast, no rules), keeps the loss and gradients on the host
    and frees the card before the others draw; then every rank draws its
    share (``launch.specs.init_params``), upcasts it and runs
    ``loss_and_grads`` with the gradients pinned to the params' layout (the
    train step's first half). Each gradient is gathered and held against
    the single process's within ``layout_f32_bound``; the same check on
    the gradient of ``LAYOUT_FAULT`` with rank 1's shard zeroed, and on
    that gradient rounded to bf16, must fail it. Returns rank 0's record
    (None elsewhere): the worst ratio to the bound, each leaf's, and each
    fault's."""
    import dataclasses
    import gc
    import torch.distributed as dist
    from repro_torch.dist import grad_sync
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import specs
    from repro_torch.models import Model
    from repro_torch.tree import tree_items
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    b, s = LAYOUT_BATCH
    k = cfg.n_layers * (b * s + cfg.d_model + cfg.d_ff + s) + cfg.vocab_size
    tol = layout_f32_bound(k)
    single = None
    if rank == 0:
        t0 = time.perf_counter()
        with shd.use_rules(None):
            params = Model(cfg, device=LAYOUT_DEVICE).init(LAYOUT_SEED)
            upcast_in_place(params)
            torch.cuda.reset_peak_memory_stats()
            loss, _, grads = grad_sync.loss_and_grads(
                Model(cfg32, device=LAYOUT_DEVICE).loss_fn, params, batch)
            peak = torch.cuda.max_memory_allocated()
            single = (float(loss), [g.cpu() for g in grads])
            del params, grads
        gc.collect()
        torch.cuda.empty_cache()
        single_s = time.perf_counter() - t0
    layout_say(rank, "single-process f32 step done")
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    p32 = upcast_placed(specs.init_params(cell, LAYOUT_SEED, dm))
    items = tree_items(p32)
    pb = specs.place_args(cell, ((), (), batch), dm)[2]
    loss, _, grads = grad_sync.loss_and_grads(
        Model(cfg32, device=LAYOUT_DEVICE).loss_fn, p32, pb)
    with shd.layout_context(p32):
        grads = shd.pin(items, grads, cell.in_shardings[0],
                        Model.stacked_dims)
    torch.cuda.synchronize()
    sharded_s = time.perf_counter() - t0
    sharded_peak = torch.cuda.max_memory_allocated()
    paths = [path for path, _ in items]
    del p32, items
    layout_free()
    layout_say(rank, f"sharded f32 gradients in {sharded_s:.1f} s")
    out = (dict(k=k, tol=tol, worst=0.0, leaves=len(paths), ratios={})
           if rank == 0 else None)
    loss = float(shd.full(loss))
    for i, (path, g) in enumerate(zip(paths, grads)):
        # each gradient whole on rank 0 only (CUDA IPC on the shared card)
        whole = gather_to_root(g, 0)
        faults = {}
        if path == LAYOUT_FAULT:
            zeroed = g.to_local().clone()
            if dist.get_rank() == 1:
                zeroed.zero_()
            rounded = g.to_local().to(torch.bfloat16).float()
            for name, local in (("zeroed_shard", zeroed),
                                ("bf16_rounded", rounded)):
                faults[name] = gather_to_root(shd.from_local(
                    local, g.device_mesh, g.placements, g.shape), 0)
            del zeroed, rounded
        if rank == 0:
            want = single[1][i].to(whole.device)
            bound = tol * float(want.abs().max())
            ratio = max_abs_chunked(whole, want) / bound if bound else (
                0.0 if torch.equal(whole, want) else math.inf)
            out["ratios"]["/".join(path)] = ratio
            out["worst"] = max(out["worst"], ratio)
            for name, fault in faults.items():
                out[f"{name}_ratio"] = max_abs_chunked(fault, want) / bound
            del want
        del whole, faults
        grads[i] = None
        layout_free()
    del grads
    layout_free()
    if rank == 0:
        out.update(loss=loss, single_loss=single[0],
                   loss_ratio=abs(loss - single[0]) / (
                       tol * abs(single[0])),
                   single_s=single_s, single_peak_bytes=peak,
                   sharded_s=sharded_s, sharded_peak_bytes=sharded_peak)
    return out


def layout_dense_runs(dm, cell, params, batch, kern):
    """The bf16 ``train`` cell twice from the same params: the same bits
    (each rank's shards), a finite loss, wall a step, peak memory."""
    from repro_torch.dist import sharding as shd
    from repro_torch.tree import tree_items
    outs, walls, peaks = [], [], []
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (new_p, _, m), counts = drive(kern, lambda: cell.fn(params, (),
                                                            batch))
        walls.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated())
        outs.append(([x.to_local() for _, x in tree_items(new_p)],
                     float(shd.full(m["loss"]))))
        del new_p
    same = all(torch.equal(a, b) for a, b in zip(outs[0][0], outs[1][0]))
    return dict(wall_s=walls, peak_bytes=peaks, loss=outs[0][1],
                same_bits=same and outs[0][1] == outs[1][1],
                launches={k: v for k, v in counts.items() if v})


def layout_compressed(dm, cell, params, batch, kern):
    """The ``train_compressed`` cell (2 pods at ``LAYOUT_WIRE_CR``) once,
    launches counted; each rank's shares of its new params and residuals
    kept as SHA-256s. Then, with the counts left alone, each leaf's pod
    gradients (``pod_gradients``, the step's own first half) brought whole
    to one place as the step brings them (``sharding.leaf_whole``):
    ``threshold_find`` and ``fused_merge`` against their twins
    (``merge_twins_on_leaf``), and ``compress_merge_leaf`` there on them,
    whose update and residuals, cut to every rank's share, must hash as
    the step's did (the same bits)."""
    import torch.distributed as dist
    from repro_torch.core import compression as comp
    from repro_torch.dist import grad_sync
    from repro_torch.dist import sharding as shd
    from repro_torch.fed.engine import compress_merge_leaf
    from repro_torch.models import Model
    from repro_torch.optim import make_optimizer
    from repro_torch.tree import tree_items
    opt = make_optimizer("sgd", LAYOUT_LR)
    state = grad_sync.init_compressed_state(opt, params, n_pods=2)
    dev = batch["tokens"].device
    crs = torch.tensor([LAYOUT_WIRE_CR, LAYOUT_WIRE_CR / 2], device=dev)
    coeffs = torch.tensor([0.5, 0.5], device=dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (new_p, st, m), counts = drive(kern, lambda: cell.fn(
        params, state, batch, crs, coeffs))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    loss = float(shd.full(m["loss"]))
    layout_say(dist.get_rank(), f"compressed step in {wall:.1f} s")
    t0 = time.perf_counter()
    # the step's shares, by their SHA-256, rank by rank (hashlib lets go
    # of the GIL, so leaves hash side by side)
    with ThreadPoolExecutor(2) as pool:
        mine = list(pool.map(
            lambda xy: (tensor_sha256(xy[0][1].to_local()),
                        tensor_sha256(xy[1][1].to_local())),
            zip(tree_items(new_p), tree_items(st["ef"]))))
    hash_s = time.perf_counter() - t0
    ef_plc = [(y.placements, tuple(y.shape))
              for _, y in tree_items(st["ef"])]
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, mine)
    del new_p, st, state, mine
    layout_free()
    model = Model(cell.meta["cfg"], device=LAYOUT_DEVICE)
    t0 = time.perf_counter()
    pods, _, _ = grad_sync.pod_gradients(model.loss_fn, params, batch, 2)
    pods_s = time.perf_counter() - t0
    twins_s = 0.0
    checked, same = [], True
    for i, (path, p) in enumerate(tree_items(params)):
        g, pods[i] = pods[i], None
        e_plc, e_shape = ef_plc[i]

        def shares_match(whole, plc, which):
            """Each rank's share of ``whole`` hashes as the step's did (the
            shares hashed side by side)."""
            nonlocal hash_s
            t0 = time.perf_counter()

            def one(share):
                r, st_, sz = share
                return tensor_sha256(whole[tuple(
                    slice(a, a + b) for a, b in zip(st_, sz))]) == \
                    everyone[r][i][which]
            shares = layout_shares(whole.shape, dm, plc)
            with ThreadPoolExecutor(len(shares)) as pool:
                ok = all(list(pool.map(one, shares)))
            hash_s += time.perf_counter() - t0
            return ok

        def check_leaf(g, pw):
            nonlocal twins_s
            n = pw.numel()
            gf = g.reshape(2, n).float()
            if n < TRAIN_MIN_LEAF:
                agg = torch.tensordot(coeffs, gf, dims=([0], [0]))
                ok = shares_match(torch.zeros(e_shape, device=gf.device),
                                  e_plc, 1)
            else:
                ks = comp.k_for_ratio_traced(
                    n, torch.clamp(crs, 0.0, LAYOUT_WIRE_CR))
                res = torch.zeros_like(gf)
                t0 = time.perf_counter()
                merge_twins_on_leaf(path, gf, res, coeffs, ks)
                twins_s += time.perf_counter() - t0
                agg, new_e = compress_merge_leaf(
                    gf, coeffs, ks, gamma=2.0, overlap_d=1, opwa=True,
                    use_kernel="auto", residuals=res)
                del res
                ok = shares_match(new_e.reshape(e_shape), e_plc, 1)
                del new_e
            del gf
            upd = pw - torch.full((), LAYOUT_LR, dtype=pw.dtype,
                                  device=pw.device) * agg.reshape(
                                      pw.shape).to(pw.dtype)
            checked.append(ok and shares_match(upd, p.placements, 0))
            return []

        shd.leaf_whole(check_leaf, (g, p), ())
        del g
        layout_free()
    return dict(wall_s=wall, peak_bytes=peak, loss=loss,
                merged_leaves=sum(1 for _, x in tree_items(params)
                                  if x.numel() >= TRAIN_MIN_LEAF),
                checked_leaves=len(checked), same_bits=all(checked),
                check_pods_s=pods_s, check_twins_s=twins_s,
                check_hash_s=hash_s,
                launches={k: v for k, v in counts.items() if v})


def layout_fl_round(dm, params, cfg, kern):
    """The ``fl_round`` cell: 2 clients (one a data slice), 2 local steps
    of B/2 = 4 sequences, every leaf merged through the kernels once."""
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import specs
    from repro_torch.tree import tree_items
    cell = specs.build_cell(LAYOUT_ARCH, "train_4k", dm, "fl_round",
                            lr=LAYOUT_LR, overrides=config_overrides(cfg),
                            fl_local_steps=LAYOUT_CLIENTS_STEPS,
                            device=LAYOUT_DEVICE)
    c, steps = cell.meta["n_clients"], LAYOUT_CLIENTS_STEPS
    bs = cell.args[1]["tokens"].shape[2]
    b = layout_batch(cfg, LAYOUT_DEVICE, lead=(c, steps))
    cb = {k: v[:, :, :bs] for k, v in b.items()}
    coef = torch.full((c,), 1.0 / c, device=LAYOUT_DEVICE)
    crs = torch.full((c,), LAYOUT_WIRE_CR, device=LAYOUT_DEVICE)
    _, cbp, coefp, crsp = specs.place_args(cell, ((), cb, coef, crs), dm)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (new_p, loss), counts = drive(kern, lambda: cell.fn(params, cbp, coefp,
                                                        crsp))
    wall = time.perf_counter() - t0
    loss = float(shd.full(loss))
    finite = math.isfinite(loss) and all(
        bool(torch.isfinite(x.to_local()).all()) for _, x in tree_items(new_p))
    return dict(clients=c, local_steps=steps, batch_per_client=bs,
                wall_s=wall, peak_bytes=torch.cuda.max_memory_allocated(),
                loss=loss, finite=finite,
                launches={k: v for k, v in counts.items() if v})


def layout_rank(rank: int, world: int, port: int, out_dir: str):
    """One rank of the layout phase (``layout_phase``); writes its record
    to ``out_dir/rank<r>.json``."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    import torch.distributed as dist
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import fused_merge as fm
    from repro_torch.kernels import threshold_find as tf
    from repro_torch.launch import mesh as mesh_t
    from repro_torch.launch import specs
    from repro_torch.tree import tree_items
    backend, dev = layout_process_group(rank, world,
                                        f"tcp://localhost:{port}")
    kern = {"threshold_find": tf.threshold_find,
            "fused_merge": fm.fused_merge}
    rec = dict(rank=rank, backend=backend, device=str(dev),
               cards=torch.cuda.device_count(), world=world)
    dm = mesh_t.device_mesh(mesh_t.make_mesh_from_spec(
        LAYOUT_MESH, ("data", "model")), dev.type)
    cfg = layout_config(LAYOUT_LAYERS)
    batch = layout_batch(cfg, dev)
    cell = specs.build_cell(LAYOUT_ARCH, "train_4k", dm, "train",
                            lr=LAYOUT_LR, overrides=config_overrides(cfg),
                            n_micro=1, device=LAYOUT_DEVICE)
    rec["fsdp"] = shd.get_rules().fsdp
    layout_say(rank, f"{backend}, {world} ranks, {dev}")
    rec["f32"] = layout_f32_check(rank, dm, cell, cfg, batch)
    layout_free()
    layout_say(rank, f"f32 check: {rec['f32']}")
    t0 = time.perf_counter()
    params = specs.init_params(cell, LAYOUT_SEED, dm)
    torch.cuda.synchronize()
    rec["init_s"] = time.perf_counter() - t0
    rec["param_bytes_local"] = sum(x.to_local().numel() * x.element_size()
                                   for _, x in tree_items(params))
    pb = specs.place_args(cell, ((), (), batch), dm)[2]
    rec["dense"] = layout_dense_runs(dm, cell, params, pb, kern)
    layout_free()
    layout_say(rank, f"dense: {rec['dense']}")
    ccell = specs.build_cell(LAYOUT_ARCH, "train_4k", dm, "train_compressed",
                             lr=LAYOUT_LR, overrides=config_overrides(cfg),
                             compressed_cr=LAYOUT_WIRE_CR,
                             device=LAYOUT_DEVICE)
    rec["compressed"] = layout_compressed(dm, ccell, params, pb, kern)
    layout_free()
    layout_say(rank, f"compressed: {rec['compressed']}")
    rec["fl_round"] = layout_fl_round(dm, params, cfg, kern)
    layout_say(rank, f"fl_round: {rec['fl_round']}")
    rec["free_bytes_seen"] = LAYOUT_FREE_SEEN
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()


def layout_phase(kern, zero, record):
    """The multi-card layout on the card the run has: 4 ranks (rank r on
    card r % device_count; NCCL with four cards, gloo when they share
    one), qwen2.5-32b at full width cut to ``LAYOUT_LAYERS`` layers on a
    (data 2, model 2) mesh through ``launch.specs.build_cell``: the f32
    gradients against the single process (``layout_f32_check``, with its
    planted fault), the bf16 ``train`` cell twice (``layout_dense_runs``),
    the ``train_compressed`` cell with both merge kernels against their
    twins and the one-process merge (``layout_compressed``), the
    ``fl_round`` cell (``layout_fl_round``). The kernels were built before
    the ranks start. Returns the launches per kernel summed over ranks."""
    import socket
    import tempfile
    import torch.multiprocessing as mp
    t_phase = time.perf_counter()
    resident, largest = resident_on_card()
    check(resident < RESIDENT_LIMIT,
          f"nothing left resident before the layout phase: "
          f"{resident / 2 ** 20:.1f} MiB; largest {largest}")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    free, total_mem = torch.cuda.mem_get_info()
    print(f"[layout] before the ranks: {free / 2 ** 30:.2f} of "
          f"{total_mem / 2 ** 30:.2f} GiB free on the card, this process "
          f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved")
    out_dir = tempfile.mkdtemp(prefix="layout_phase_")
    mp.spawn(layout_rank, args=(LAYOUT_RANKS, port, out_dir),
             nprocs=LAYOUT_RANKS)
    ranks = []
    for r in range(LAYOUT_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    r0 = ranks[0]
    f32 = r0["f32"]
    print(f"[layout] backend {r0['backend']}, world {r0['world']}, cards "
          f"{sorted({r['device'] for r in ranks})} of {r0['cards']} "
          f"({LAYOUT_RANKS} ranks), mesh (data {LAYOUT_MESH[0]}, model "
          f"{LAYOUT_MESH[1]}), fsdp {r0['fsdp']}")
    check(all(r["fsdp"] for r in ranks), "the cut keeps FSDP on")
    print(f"[layout] f32 gradients / (6 * 2^-24 * sqrt(K) * max|g|), K = "
          f"{f32['k']}, by leaf: "
          f"{json.dumps({k: round(v, 5) for k, v in f32['ratios'].items()})}")
    check(f32["worst"] <= 1.0 and f32["loss_ratio"] <= 1.0,
          f"sharded f32 gradients within 6 * 2^-24 * sqrt(K) * max|g| of "
          f"the single process: worst {f32['worst']:.3g}, loss "
          f"{f32['loss_ratio']:.3g}")
    for name in ("zeroed_shard", "bf16_rounded"):
        check(f32[f"{name}_ratio"] > 1.0,
              f"{'.'.join(LAYOUT_FAULT)} with its gradient's {name} fails "
              f"the bound: {f32[f'{name}_ratio']:.3g}")
    n_compressed = r0["compressed"]["merged_leaves"]
    n_leaves = f32["leaves"]
    # ranks sharing a card merge every leaf on rank 0 (merge_on_root)
    shared = r0["cards"] < r0["world"]
    total = dict(zero)
    for r in ranks:
        merges = not shared or r["rank"] == 0
        d, c, fl = r["dense"], r["compressed"], r["fl_round"]
        check(d["same_bits"] and math.isfinite(d["loss"]),
              f"rank {r['rank']}: the bf16 step twice, same bits, finite")
        check(not d["launches"], f"the dense step launches no merge kernel")
        check(c["same_bits"], f"rank {r['rank']}: the compressed step's "
              f"update and residuals are the one-process merge's bits")
        check(c["checked_leaves"] == f32["leaves"] or (
            r["rank"] and not c["checked_leaves"]),
              f"rank {r['rank']}: checked {c['checked_leaves']} of "
              f"{f32['leaves']} leaves (rank 0 checks them all)")
        want = ({"threshold_find": n_compressed, "fused_merge": n_compressed}
                if merges else {})
        check_counts(c["launches"], want, f"rank {r['rank']} compressed")
        check(fl["finite"], f"rank {r['rank']}: fl_round finite")
        want = ({"threshold_find": n_leaves, "fused_merge": n_leaves}
                if merges else {})
        check_counts(fl["launches"], want, f"rank {r['rank']} fl_round")
        for part in (c, fl):
            for name, n in part["launches"].items():
                total[name] += n
    gb = 2.0 ** 30
    summary = dict(
        backend=r0["backend"], world=r0["world"], cards=r0["cards"],
        f32=f32, init_s=max(r["init_s"] for r in ranks),
        param_gb_per_rank=[r["param_bytes_local"] / gb for r in ranks],
        dense_wall_s=[max(r["dense"]["wall_s"][i] for r in ranks)
                      for i in range(2)],
        dense_peak_gb=[max(r["dense"]["peak_bytes"]) / gb for r in ranks],
        dense_loss=r0["dense"]["loss"],
        compressed_wall_s=max(r["compressed"]["wall_s"] for r in ranks),
        compressed_peak_gb=[r["compressed"]["peak_bytes"] / gb
                            for r in ranks],
        compressed_leaves=n_compressed,
        compressed_check_s={k: r0["compressed"][f"check_{k}_s"]
                            for k in ("pods", "twins", "hash")},
        sum_of_rank_peaks_gb={
            part: sum(max(r[part]["peak_bytes"]) if part == "dense"
                      else r[part]["peak_bytes"] for r in ranks) / gb
            for part in ("dense", "compressed", "fl_round")},
        card_free_gib_at_marks=[f / gb for f in r0["free_bytes_seen"]],
        fl_round_wall_s=max(r["fl_round"]["wall_s"] for r in ranks),
        fl_round_peak_gb=[r["fl_round"]["peak_bytes"] / gb for r in ranks],
        fl_round_loss=r0["fl_round"]["loss"],
        launches={k: v for k, v in total.items() if v},
        seconds=time.perf_counter() - t_phase)
    record["layout_phase"] = summary
    print(f"[layout phase] {json.dumps(summary)}")
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full record as JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="also profile 3 rounds of the fused, legacy and "
                         "population paths, 3 async flushes, one full-width "
                         "fl_train step, 3 decode steps of each serve path "
                         "and the row kernels at the main shape")
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
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_merge as fm
    from repro_torch.kernels import overlap_combine as oc
    from repro_torch.kernels import threshold_find as tf
    modules = {"threshold_find": tf, "fused_merge": fm, "overlap_combine": oc,
               "block_topk": bt, "ef_update": eu, "flash_attention": fa,
               "flash_attention_wgmma": fa}
    # each kernel's launch counter lives on the function that launches it
    # (the entry point's name, or flash_attention_wgmma_cuda)
    kern = {name: getattr(mod, name if name != "flash_attention_wgmma"
                          else "flash_attention_wgmma_cuda")
            for name, mod in modules.items()}
    check(tuple(sorted(build.KERNELS)) == tuple(sorted(kern)),
          "chip_smoke covers every kernel that build.KERNELS lists")

    record = {"torch": torch.__version__, "cuda": torch.version.cuda}
    t0 = time.perf_counter()
    build.check_device()
    build.build()
    record["build_s"] = time.perf_counter() - t0
    print(f"[build] {len(build.KERNELS)} kernels in {record['build_s']:.1f} s")

    t0 = time.perf_counter()
    worst = kernel_parity(tf, fm, (MAIN, PRICED, LEAF, RAGGED, ASYNC_BUFFER,
                                   POP_COHORT), record)
    threshold_adversarial(tf, record)
    threshold_launches_per_call(tf, record)
    worst.update(block_parity(modules, record))
    print(f"[parity] {record['parity_cases']} + "
          f"{record['block_parity_cases']} cases bitwise equal "
          f"({time.perf_counter() - t0:.1f} s)")
    rows = kernel_timings(tf, fm, record) + block_timings(
        modules, record, args.profile)
    for row in rows:
        print("[timing]", json.dumps(row))

    # the layout phase first, while this process holds nothing on the card
    # but its context: its four ranks share the card with it
    layout_launches = layout_phase(kern, {name: 0 for name in kern}, record)
    check(layout_launches["threshold_find"] > 0
          and layout_launches["fused_merge"] > 0,
          f"both merge kernels launched in the layout phase: "
          f"{layout_launches}")
    launches = run_paths(kern, record)
    for name, n in layout_launches.items():
        launches[name] += n
    reference_check(record)
    print(f"[reference] aggregate_updates kernels vs plain path: max |d agg| "
          f"{record['reference_check_max_abs_agg_diff']:.3g}")
    legacy_reference_check(record)
    graph_replay_parity(tf, fm, oc, record)
    scan_launches = scan_phase(kern, {name: 0 for name in kern}, record)
    for name, n in scan_launches.items():
        launches[name] += n
    pop_launches = population_async_phase(kern, {name: 0 for name in kern},
                                          record)
    for name, n in pop_launches.items():
        launches[name] += n
    fl_launches, fl_worst, fl_rows = fl_train_phase(
        kern, {name: 0 for name in kern}, record)
    for name, n in fl_launches.items():
        launches[name] += n
    for name, err in fl_worst.items():
        worst[name] = max(worst[name], err)
    record["timings"] += fl_rows
    # cut for the script's time (full width): stablelm's 24 layers to
    # CUT_LAYERS here, hymba's 32 and rwkv6's 24 below, the vlm to 2 of its
    # 8 groups in the cross phase
    with at_depth(CUT_LAYERS):
        train_launches = train_phase(kern, {name: 0 for name in kern},
                                     record)
    for name, n in train_launches.items():
        launches[name] += n
    if args.profile:
        from repro_torch.core.aggregation import AggregationConfig
        record["profile"] = profile_path(
            "fused", AggregationConfig(strategy="bcrs_opwa"))
        record["profile_legacy"] = profile_path(
            "legacy", AggregationConfig(strategy="bcrs_opwa",
                                        block_topk=True))
        print("[profile]", json.dumps(record["profile"]))
        print("[profile legacy]", json.dumps(record["profile_legacy"]))
        eftopk = AggregationConfig(strategy="eftopk")
        for engine in ("population", "async"):
            record[f"profile_{engine}"] = profile_path(engine, eftopk)
            print(f"[profile {engine}]",
                  json.dumps(record[f"profile_{engine}"]))
        profile_fl_step(record)
    flash_worst, wgmma_worst, flash_rows, flash_counts = serve_phase(
        kern, {name: 0 for name in kern}, record, args.profile)
    worst["flash_attention"] = flash_worst
    worst["flash_attention_wgmma"] = wgmma_worst
    for name, n in flash_counts.items():
        launches[name] += n
    recurrent_serve_phase(kern, {name: 0 for name in kern}, record,
                          args.profile)
    with at_depth(CUT_LAYERS):
        rec_train_launches = recurrent_train_phase(
            kern, {name: 0 for name in kern}, record)
    for name, n in rec_train_launches.items():
        launches[name] += n
    cross_launches = cross_phase(kern, {name: 0 for name in kern}, record)
    for name, n in cross_launches.items():
        launches[name] += n
    check(cross_launches["threshold_find"] > 0
          and cross_launches["fused_merge"] > 0,
          f"both merge kernels launched in the cross phase: "
          f"{cross_launches}")
    moe_launches = moe_phase(kern, {name: 0 for name in kern}, record)
    for name, n in moe_launches.items():
        launches[name] += n
    check(moe_launches["threshold_find"] > 0
          and moe_launches["fused_merge"] > 0,
          f"both merge kernels launched in the moe phase: {moe_launches}")
    check(all(n > 0 for n in launches.values()),
          f"every kernel launched on its path: {launches}")

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
        extra = (dict(launches_per_call=record[
            "threshold_find_launches_per_call"],
            reads_of_x=record["main_path_reads_of_x"])
                 if name == "threshold_find" else {})
        if name in scan_launches and scan_launches[name]:
            extra["scan_phase_launches"] = scan_launches[name]
        if pop_launches[name]:
            extra["population_async_phase_launches"] = pop_launches[name]
        if train_launches[name]:
            extra["train_phase_launches"] = train_launches[name]
        if rec_train_launches[name]:
            extra["recurrent_train_phase_launches"] = rec_train_launches[
                name]
        if cross_launches[name]:
            extra["cross_phase_launches"] = cross_launches[name]
        if moe_launches[name]:
            extra["moe_phase_launches"] = moe_launches[name]
        if layout_launches[name]:
            extra["layout_phase_launches"] = layout_launches[name]
        if fl_launches[name]:
            extra["fl_train_phase_launches"] = fl_launches[name]
            # the w_up leaf as the CLI's rounds give it: C = 8 (OPWA) and
            # C = 4 under EF
            for r in fl_rows:
                if r["kernel"] == name:
                    tag = "wup_ef" if r["shape"] == "w_up ef" else "wup"
                    extra.update({f"{tag}_ms": r["ms"],
                                  f"{tag}_plain_ms": r["plain_ms"],
                                  f"{tag}_bound_ms": r["bound_ms"],
                                  f"{tag}_library_ms": r["library_ms"]})
        if name in ("block_topk", "ef_update"):
            # the wide path ([8, 32768]) and a longer row ([4, 262144])
            for r in rows:
                if r["kernel"] == name and r["shape"] in ("wide", "long"):
                    extra.update({f"{r['shape']}_ms": r["ms"],
                                  f"{r['shape']}_bound_ms": r["bound_ms"],
                                  f"{r['shape']}_library_ms":
                                      r["library_ms"]})
            if "block_device_ms_per_call" in record:
                extra["device_ms_per_call"] = record[
                    "block_device_ms_per_call"][name]
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{name}.cu",
            replaces=replaces, launches=launches[name],
            max_abs_err=worst[name], ms=m["ms"], plain_ms=m["plain_ms"],
            bound_ms=m["bound_ms"], bound_by=m["bound_by"],
            library_ms=m["library_ms"], leaf_ms=lf["ms"],
            leaf_plain_ms=lf["plain_ms"], leaf_bound_ms=lf["bound_ms"],
            leaf_library_ms=lf["library_ms"], parity="bitwise", **extra))
    old = {r["shape"]: r for r in flash_rows
           if r["kernel"] == "flash_attention" and "bfloat16" in r["variant"]}
    fl32 = next(r for r in flash_rows if "float32" in r["variant"])
    m, big = old["serve"], old["32k"]
    kernels.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:53",
        launches=launches["flash_attention"],
        max_abs_err=worst["flash_attention"], ms=m["ms"],
        plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
        bound_by=m["bound_by"], library_ms=m["library_ms"],
        shape=m["variant"], f32_ms=fl32["ms"], f32_plain_ms=fl32["plain_ms"],
        f32_bound_ms=fl32["bound_ms"], f32_library_ms=fl32["library_ms"],
        ms_32k=big["ms"], plain_ms_32k=big["plain_ms"],
        bound_ms_32k=big["bound_ms"], library_ms_32k=big["library_ms"],
        parity="within B = (D + Sk + 8) * 2^-24 * max|v| (f32), B + 1 ULP "
               "(bf16); bf16 == bf16(f32 kernel on upcasts)"))
    wg = {r["shape"]: r for r in flash_rows
          if r["kernel"] == "flash_attention_wgmma"}
    m, yi, big = wg["serve"], wg["yi-9b heads"], wg["32k"]
    kernels.append(dict(
        name="flash_attention_wgmma", route="cuda",
        source="src/repro_torch/csrc/flash_attention_wgmma.cu",
        replaces="src/repro/kernels/flash_attention.py:53",
        launches=launches["flash_attention_wgmma"],
        max_abs_err=worst["flash_attention_wgmma"], ms=m["ms"],
        plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
        bound_by=m["bound_by"], library_ms=m["library_ms"],
        shape=m["variant"], yi9b_ms=yi["ms"], yi9b_plain_ms=yi["plain_ms"],
        yi9b_bound_ms=yi["bound_ms"], yi9b_library_ms=yi["library_ms"],
        ms_32k=big["ms"], plain_ms_32k=big["plain_ms"],
        bound_ms_32k=big["bound_ms"], library_ms_32k=big["library_ms"],
        parity="within wgmma_twin_and_bound + 1 bf16 ULP of its twin; twin "
               "within wgmma_twin_and_bound(both_round=False) + 1 ULP of the "
               "f32 twin; the check rejects a skipped key tile"))
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
