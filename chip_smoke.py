"""Smoke run of the PyTorch/CUDA port on one Hopper card.

    python3 chip_smoke.py [--out PATH] [--profile]

1. builds the two hand-written kernels (``src/repro_torch/csrc``; one nvcc
   per source, started together);
2. holds each kernel bit for bit against its plain PyTorch twin, for every
   variant, at the main path's shape (C=5, n=136,724), the README's priced
   point (C=32, n=65,536), a real-model leaf (C=8, n=2048*5632, the
   stablelm-1.6b MLP matrix) and a ragged edge (C=3, n=1001), and times
   kernel, twin and the nearest single PyTorch call with CUDA events;
3. drives the main path, ``run_fl(engine="fused")`` at the simulation MLP's
   full width for 5 rounds under bcrs_opwa, eftopk, qtopk and int4, with the
   kernels' launch counters reset just before and read just after;
4. holds ``aggregate_updates`` on the card (kernel route) against the plain
   path on the CPU for all 8 built-in strategies;
5. with ``--profile``, profiles 3 rounds of the main path (device time by
   kernel, idle share).

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
ROUNDS = 5


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


# ------------------------------------------------------------ main path
def main_path(tf, fm, record):
    from repro_torch.core.aggregation import AggregationConfig
    from repro_torch.fed.simulation import FLSimConfig, run_fl
    runs = {}
    tf.threshold_find.launches = 0
    fm.fused_merge.launches = 0
    for s in STRATEGIES:
        t0, f0 = tf.threshold_find.launches, fm.fused_merge.launches
        res = run_fl(FLSimConfig(rounds=ROUNDS), AggregationConfig(strategy=s),
                     engine="fused", device="cuda")
        n_tf = tf.threshold_find.launches - t0
        n_fm = fm.fused_merge.launches - f0
        accs = [a for _, a in res.accuracies]
        check(len(res.executed_rounds) == ROUNDS, f"{s}: rounds executed")
        check(all(math.isfinite(v) for v in res.losses + accs),
              f"{s}: finite losses and accuracies")
        check(n_tf == ROUNDS and n_fm == ROUNDS,
              f"{s}: one launch of each kernel per round "
              f"(threshold_find {n_tf}, fused_merge {n_fm})")
        runs[s] = dict(accuracies=res.accuracies, losses=res.losses,
                       wall_per_round_s=res.wall_per_round,
                       threshold_find_launches=n_tf, fused_merge_launches=n_fm)
        print(f"[main path] {s}: wall per round (s) "
              f"{[round(t, 6) for t in res.wall_per_round]} "
              f"accuracies {res.accuracies} launches tf={n_tf} fm={n_fm}")
    launches = {"threshold_find": tf.threshold_find.launches,
                "fused_merge": fm.fused_merge.launches}
    record["main_path"] = runs
    return launches


# ------------------------------------------------------ reference check
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
        bound = 2 * c * 2.0 ** -24 * gamma * (w[:, None] * vals).abs().sum(0)
        diff = (agg_k - agg_p).abs()
        check(bool((diff <= bound).all()),
              f"{name}: agg within the summation-order bound")
        worst = max(worst, float(diff.max()))
    record["reference_check_max_abs_agg_diff"] = worst


# -------------------------------------------------------------- profile
def profile_main_path(record):
    """Where the device time of the main path goes: ``run_fl`` (bcrs_opwa,
    3 rounds, warm process) under ``torch.profiler``; device time summed by
    kernel name, and the busy share of the run's wall time. Reports "not
    measured" when the profiler shows no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.aggregation import AggregationConfig
    from repro_torch.fed.simulation import FLSimConfig, run_fl
    rounds = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run_fl(FLSimConfig(rounds=rounds),
                     AggregationConfig(strategy="bcrs_opwa"), device="cuda")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.key_averages():
        # kernel events only: a CPU op's device time repeats its kernels'
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total:
            by_name[ev.key] = (ev.self_device_time_total / 1e3, ev.count)
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    prof_rec = dict(
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
    record["profile"] = prof_rec
    return prof_rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full record as JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="also profile 3 rounds of the main path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke "
              "run needs one CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_merge as fm
    from repro_torch.kernels import threshold_find as tf

    record = {"torch": torch.__version__, "cuda": torch.version.cuda}
    t0 = time.perf_counter()
    build.check_device()
    build.build()
    record["build_s"] = time.perf_counter() - t0
    print(f"[build] both kernels in {record['build_s']:.1f} s")

    t0 = time.perf_counter()
    worst = kernel_parity(tf, fm, (MAIN, PRICED, LEAF, RAGGED), record)
    print(f"[parity] {record['parity_cases']} cases bitwise equal "
          f"({time.perf_counter() - t0:.1f} s)")
    rows = kernel_timings(tf, fm, record)
    for row in rows:
        print("[timing]", json.dumps(row))

    launches = main_path(tf, fm, record)
    check(launches["threshold_find"] > 0 and launches["fused_merge"] > 0,
          "both kernels launched on the main path")
    reference_check(record)
    print(f"[reference] aggregate_updates kernels vs plain path: max |d agg| "
          f"{record['reference_check_max_abs_agg_diff']:.3g}")
    if args.profile:
        print("[profile]", json.dumps(profile_main_path(record)))

    main_rows = {(r["kernel"], r["variant"]): r for r in rows
                 if r["shape"] == "main"}
    leaf_rows = {(r["kernel"], r["variant"]): r for r in rows
                 if r["shape"] == "leaf"}
    kernels = []
    for name, variant, source, replaces in (
            ("threshold_find", "x only", "src/repro_torch/csrc/threshold_find.cu",
             "src/repro/kernels/threshold_find.py:130"),
            ("fused_merge", "opwa (bcrs_opwa)",
             "src/repro_torch/csrc/fused_merge.cu",
             "src/repro/kernels/fused_merge.py:112")):
        m, lf = main_rows[(name, variant)], leaf_rows[(name, variant)]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=worst[name],
            ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
            bound_by=m["bound_by"], library_ms=m["library_ms"],
            leaf_ms=lf["ms"], leaf_plain_ms=lf["plain_ms"],
            leaf_bound_ms=lf["bound_ms"], leaf_library_ms=lf["library_ms"],
            parity="bitwise"))
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
