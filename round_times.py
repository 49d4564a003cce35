"""Wall time per round of the port's FL paths on one CUDA card, and
where the card's time per round goes, by kernel, under ``torch.profiler``;
with ``--rows``, the row kernels ``block_topk`` and ``ef_update`` instead.

    python3 round_times.py [--engine fused|scan] [--rows]
                           [--train | --prefill] [--arch ARCH] [--src DIR]
                           [--out PATH]

For each of ``STRATEGIES``: ``run_fl(engine=...)`` ("fused" by default;
"scan" replays one captured CUDA graph a round, and its wall per round is
the replay loop's over the rounds) at the simulation MLP's full width
(``FLSimConfig()`` defaults, cohort 5) for ``ROUNDS`` rounds, host clock
per round as ``run_fl`` records it, and the host time
spent inside ``threshold_find_cuda`` (its checks, allocations and
launches; host clock, no synchronisation) per call; then
``PROFILE_ROUNDS`` more rounds under the profiler, device time summed by
kernel name a round, with the kernels of ``threshold_find`` (the radix
passes, or the older sweep and finalize kernels) and the memsets totalled
apart.

``--rows``: at each of ``ROW_SHAPES`` (the main path's rows [17, 8192],
the stablelm-1.6b MLP leaf [1408, 8192], the wide path [8, 32768] and a
longer row [4, 262144]), at the default ratio's k, both row kernels held
bit for bit against their twins, then timed with CUDA events beside the
twin and ``torch.topk`` (``chip_smoke.row_kernel_rows``), and their device
time a call under the profiler (``chip_smoke.row_kernel_device_ms``).

``--train``: the real-model trainers at full width instead, for ``--arch``
(stablelm-1.6b by default): ``launch.train`` at its CLI defaults (dense
sgd, B = 8, S = 256, ``TRAIN_STEPS`` steps), then ``launch.fl_train`` at
its defaults (bcrs_opwa, C = 8, ``FL_ROUNDS`` rounds) through the round
engine and through the mesh scan; each run's wall a step or round as
the launch module records it, its losses and its peak memory
(``torch.cuda.max_memory_allocated``).

``--prefill``: ``Model.prefill`` of ``--arch`` at full width instead
(bf16, random weights from seed 0, B = ``PREFILL_BATCH`` x
``PREFILL_TOKENS`` tokens, under ``torch.no_grad``): one warm call, then
``PREFILL_REPEATS`` timed calls (host clock ending in a synchronize), the
peak memory over them (``torch.cuda.max_memory_allocated``, the weights
included) and a SHA-256 of the last call's logits, so two trees can be
held to the same bits.

``--src`` names the ``src`` directory of the tree to time (default: this
checkout's), so one card can time two trees in alternation: parent,
change, change, parent, each its own process. Prints one JSON line;
``--out`` also writes it to a file. Needs CUDA.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import sys
import time

import torch

#: kernels of threshold_find, in this tree and in the one before the radix
#: select (8 sweeps and a finalize)
THRESHOLD_KERNELS = re.compile(r"radix_pass|count_kernel|finalize_kernel")
#: the fused path's strategies: global Top-K, with EF, with the int8 codec
STRATEGIES = ("bcrs_opwa", "eftopk", "qtopk")
ROUNDS, PROFILE_ROUNDS = 30, 5
HERE = os.path.dirname(os.path.abspath(__file__))
#: [nb, block] rows of ``--rows``
ROW_SHAPES = (("main", (17, 8192)), ("leaf", (1408, 8192)),
              ("wide", (8, 32768)), ("long", (4, 262144)))


def profile_rounds(run_fl, sim, acfg, engine):
    """Device ms per round by kernel name over ``sim.rounds`` rounds (the
    scan engine also runs ``engine.WARMUP`` eager rounds before its
    capture: they count as rounds here)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run_fl(sim, acfg, engine=engine, device="cuda")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rounds = sim.rounds
    if engine == "scan":
        from repro_torch.fed.engine import WARMUP
        rounds += WARMUP
    per_round = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total:
            per_round[ev.key] = ev.self_device_time_total / 1e3 / rounds
    tf_ms = sum(ms for k, ms in per_round.items()
                if THRESHOLD_KERNELS.search(k))
    memset_ms = sum(ms for k, ms in per_round.items() if "emset" in k)
    busy = sum(per_round.values())
    top = sorted(per_round.items(), key=lambda kv: -kv[1])[:8]
    return dict(
        wall_ms_per_round_under_profiler=wall_ms / sim.rounds,
        round_wall_ms=[t * 1e3 for t in res.wall_per_round],
        device_ms_per_round=busy if per_round else "not measured",
        threshold_find_device_ms_per_round=(tf_ms if per_round
                                            else "not measured"),
        memset_device_ms_per_round=(memset_ms if per_round
                                    else "not measured"),
        top_kernels_ms_per_round={k[:80]: v for k, v in top})


def round_times(src: str, engine: str) -> dict:
    """The ``engine``'s rounds under each of ``STRATEGIES``."""
    from repro_torch.core.aggregation import AggregationConfig
    from repro_torch.fed.simulation import FLSimConfig, run_fl
    from repro_torch.kernels import build
    from repro_torch.kernels import threshold_find as tf
    build.build()
    host_ms = []
    launch = tf.threshold_find_cuda

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = launch(*a, **kw)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        return out
    tf.threshold_find_cuda = timed
    out = dict(src=src, engine=engine, rounds=ROUNDS,
               gpu=torch.cuda.get_device_name(0), strategies={})
    for s in STRATEGIES:
        acfg = AggregationConfig(strategy=s)
        host_ms.clear()
        res = run_fl(FLSimConfig(rounds=ROUNDS), acfg, engine=engine,
                     device="cuda")
        walls = [t * 1e3 for t in res.wall_per_round]
        calls = list(host_ms[1:])          # the first call loads the library
        # fused: round 0 carries the first staging; scan: one replay-loop
        # mean, the same for every round
        steady = walls[1:]
        prof = profile_rounds(run_fl, FLSimConfig(rounds=PROFILE_ROUNDS),
                              acfg, engine)
        out["strategies"][s] = dict(
            wall_ms=walls, median_ms=statistics.median(steady),
            mean_ms=statistics.fmean(steady), min_ms=min(steady),
            max_ms=max(steady), profile=prof,
            threshold_find_host_ms_per_call=dict(
                calls=len(calls), median=statistics.median(calls),
                mean=statistics.fmean(calls)))
        print(f"[rounds] {s}: median {statistics.median(steady):.4f} ms, "
              f"min {min(steady):.4f}, max {max(steady):.4f} over "
              f"{len(steady)} rounds; threshold_find device "
              f"{prof['threshold_find_device_ms_per_round']} ms a round, "
              f"host {statistics.median(calls):.4f} ms a call",
              file=sys.stderr)
    return out


def row_times(src: str) -> dict:
    """``block_topk`` and ``ef_update`` at each of ``ROW_SHAPES``."""
    sys.path.insert(1, HERE)
    import chip_smoke as cs
    from repro_torch.core.compression import k_for_ratio
    from repro_torch.kernels import block_topk as bt
    from repro_torch.kernels import build
    from repro_torch.kernels import ef_update as eu
    build.build(["block_topk", "ef_update"])
    out = dict(src=src, gpu=torch.cuda.get_device_name(0), shapes={})
    for label, (nb, block) in ROW_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(nb)
        x = torch.randn(nb, block, device="cuda", generator=g)
        e = 0.3 * torch.randn(nb, block, device="cuda", generator=g)
        k = k_for_ratio(block, cs.CR)
        same = (cs.bits_equal(bt.block_topk(x, k)[0],
                              bt.block_topk_plain(x, k)[0])
                and all(cs.bits_equal(a, b) for a, b in zip(
                    eu.ef_update(x, e, k), eu.ef_update_plain(x, e, k))))
        cs.check(same, f"block kernels vs twins at [{nb}, {block}]")
        del x, e
        rows = cs.row_kernel_rows(bt, eu, label, nb, block,
                                  10 if label == "leaf" else 30)
        dev = cs.row_kernel_device_ms(bt, eu, nb, block)
        out["shapes"][label] = {
            r["kernel"]: dict(ms=r["ms"], device_ms_per_call=dev[r["kernel"]],
                              bound_ms=r["bound_ms"], plain_ms=r["plain_ms"],
                              library_ms=r["library_ms"], variant=r["variant"])
            for r in rows}
        print(f"[rows] {label}: " + ", ".join(
            f"{r['kernel']} {r['ms']:.4f} ms (device "
            f"{dev[r['kernel']]}, torch.topk {r['library_ms']:.4f})"
            for r in rows), file=sys.stderr)
    return out


TRAIN_STEPS, FL_ROUNDS = 4, 4


def train_times(src: str, arch: str) -> dict:
    """``--train``: the trainers' wall, losses and peak memory."""
    import gc
    from repro_torch.launch import fl_train as fl
    from repro_torch.launch import train as tr
    out = dict(src=src, gpu=torch.cuda.get_device_name(0), arch=arch)
    runs = (("train", lambda: tr.run(tr.TrainConfig(
                arch=arch, steps=TRAIN_STEPS, device="cuda")),
             "wall_per_step"),
            ("fl_round", lambda: fl.run(fl.FLTrainConfig(
                arch=arch, rounds=FL_ROUNDS, engine="round",
                device="cuda")), "wall_per_round"),
            ("fl_scan", lambda: fl.run(fl.FLTrainConfig(
                arch=arch, rounds=FL_ROUNDS, engine="scan",
                device="cuda")), "wall_per_round"))
    for name, fn, wall_key in runs:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res = fn()
        torch.cuda.synchronize()
        out[name] = dict(wall_s=res[wall_key], losses=res["losses"],
                         peak_memory_bytes=torch.cuda.max_memory_allocated())
        del res
    return out


PREFILL_BATCH, PREFILL_TOKENS, PREFILL_REPEATS = 4, 2048, 5


def prefill_times(src: str, arch: str) -> dict:
    """``--prefill``: ``Model.prefill``'s wall a call and peak memory."""
    import hashlib
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    model = Model(get_config(arch), device="cuda")
    params = model.init(0)
    prompt = torch.as_tensor(np.random.default_rng(4).integers(
        0, model.cfg.vocab_size, (PREFILL_BATCH, PREFILL_TOKENS)),
        device="cuda")
    ms = []
    with torch.no_grad():
        model.prefill(params, {"tokens": prompt})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(PREFILL_REPEATS):
            t0 = time.perf_counter()
            logits, _ = model.prefill(params, {"tokens": prompt})
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    digest = hashlib.sha256(logits.float().cpu().numpy().tobytes())
    return dict(src=src, gpu=torch.cuda.get_device_name(0), arch=arch,
                batch=PREFILL_BATCH, tokens=PREFILL_TOKENS, ms=ms,
                median_ms=statistics.median(ms),
                peak_memory_bytes=torch.cuda.max_memory_allocated(),
                logits_sha256=digest.hexdigest())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", action="store_true",
                    help="time block_topk and ef_update, not the rounds")
    ap.add_argument("--engine", choices=("fused", "scan"), default="fused",
                    help="the round engine to time (the scan engine needs "
                         "a tree that has it)")
    ap.add_argument("--train", action="store_true",
                    help="time launch.train and launch.fl_train at full "
                         "width, not the simulation's rounds")
    ap.add_argument("--prefill", action="store_true",
                    help="time Model.prefill at full width, not the rounds")
    ap.add_argument("--arch", default="stablelm-1.6b",
                    help="the model of --train or --prefill")
    ap.add_argument("--src", default=os.path.join(HERE, "src"))
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("round_times: needs a CUDA card", file=sys.stderr)
        return 1
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    if args.train:
        out = train_times(src, args.arch)
    elif args.prefill:
        out = prefill_times(src, args.arch)
    elif args.rows:
        out = row_times(src)
    else:
        out = round_times(src, args.engine)
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
