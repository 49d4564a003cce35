"""The port's roofline layer (``repro_torch.roofline``, ``models.flags``)
against the reference's ``repro.roofline`` and ``repro.models.flags``.

What is held, and how:
  * ``model_flops``: equal to the reference's on every arch x shape (host
    arithmetic on the same config numbers);
  * ``Roofline``: every property and ``to_dict`` key equal to the
    reference's on the same inputs, each side with its own constants (only
    ``compute_fraction`` reads a constant: the peak);
  * the ring wire factors and the cross-pod classification: equal to the
    reference's ``parse_collectives`` on HLO snippets of each kind (the
    reference test's own among them);
  * ``op_cost.OpCounter``: exact on a sharded product on a fake 256-rank
    mesh (rank 0's share, 8,388,608 FLOPs, not the global product's), on a
    Python loop of L products, and on one all-gather, one all-reduce and
    one reduce-scatter (kind, result bytes, group size, pods), on fake
    process groups that each test destroys;
  * ``kernel_bytes``: the pipeline's bytes against its launch-structure
    formula, the plain route at least 3x the kernels' traffic for
    bcrs_opwa and eftopk at (8, 2^13), ``wire_stream_bytes`` equal to the
    reference's for every non-dense strategy, and each bound count equal
    to the expression ``chip_smoke.py`` computed by hand before it moved
    here (the decode bytes on a reduced model);
  * ``models.flags``: the reference's two names.
"""
import dataclasses
import math

import pytest
import torch

torch.set_num_threads(1)

from repro import configs as rc  # noqa: E402
from repro.models import flags as ref_flags  # noqa: E402
from repro.roofline import analysis as ra  # noqa: E402
from repro.roofline import kernel_bytes as rkb  # noqa: E402
from repro_torch import configs as tc  # noqa: E402
from repro_torch.models import flags as tflags  # noqa: E402
from repro_torch.roofline import analysis as ta  # noqa: E402
from repro_torch.roofline import kernel_bytes as kb  # noqa: E402
from repro_torch.roofline.op_cost import OpCounter  # noqa: E402


# ------------------------------------------------------------- model flops
@pytest.mark.parametrize("shape", list(rc.SHAPES))
@pytest.mark.parametrize("arch", rc.ARCH_IDS)
def test_model_flops_equal_to_the_reference(arch, shape):
    ref = ra.model_flops(rc.get_config(arch), rc.SHAPES[shape])
    got = ta.model_flops(tc.get_config(arch), tc.SHAPES[shape])
    assert got == ref


# ---------------------------------------------------------------- Roofline
ROOFLINE_INPUTS = {
    "compute": dict(compute_s=2.0, memory_s=0.5, collective_s=0.25,
                    flops_per_device=3.2e14, bytes_per_device=4.1e11,
                    wire_bytes_per_device=1.0e10, model_flops_global=6.0e16,
                    hlo_total_flops_global=8.0e16, n_devices=256,
                    coll_by_kind={"ici/all-reduce": 1.0e10},
                    n_collectives=12),
    "memory": dict(compute_s=0.1, memory_s=1.5, collective_s=0.3,
                   flops_per_device=1.0e12, bytes_per_device=5.0e12,
                   wire_bytes_per_device=3.0e9, model_flops_global=2.0e14,
                   hlo_total_flops_global=5.12e14, n_devices=512,
                   coll_by_kind={"ici/all-gather": 2.0e9,
                                 "dcn/all-reduce": 1.0e9},
                   n_collectives=3),
    "collective": dict(compute_s=0.01, memory_s=0.02, collective_s=0.5,
                       flops_per_device=1.0e10, bytes_per_device=1.0e9,
                       wire_bytes_per_device=2.5e10, model_flops_global=0.0,
                       hlo_total_flops_global=0.0, n_devices=256,
                       coll_by_kind={}, n_collectives=0),
    "zero": dict(compute_s=0.0, memory_s=0.0, collective_s=0.0,
                 flops_per_device=0.0, bytes_per_device=0.0,
                 wire_bytes_per_device=0.0, model_flops_global=1.0,
                 hlo_total_flops_global=0.0, n_devices=1, coll_by_kind={},
                 n_collectives=0),
}


@pytest.mark.parametrize("case", list(ROOFLINE_INPUTS))
def test_roofline_properties_equal_to_the_reference(case):
    kw = ROOFLINE_INPUTS[case]
    ref = ra.Roofline(**kw)
    got = ta.Roofline(**kw)
    r, g = ref.to_dict(), got.to_dict()
    assert list(g) == list(r)
    for key in r:
        if key == "compute_fraction":
            continue
        assert g[key] == r[key], key
    for prop in ("dominant", "step_time_s", "model_flops_ratio",
                 "hbm_fraction"):
        assert getattr(got, prop) == getattr(ref, prop)
    # the one constant a property reads: each side's own peak
    t = got.step_time_s
    want = (0.0 if t <= 0 else
            kw["model_flops_global"] / kw["n_devices"] / ta.PEAK_FLOPS / t)
    assert got.compute_fraction == want == g["compute_fraction"]
    if t > 0:
        assert ref.compute_fraction == (kw["model_flops_global"]
                                        / kw["n_devices"] / ra.PEAK_FLOPS / t)


def test_h100_constants():
    assert (ta.PEAK_FLOPS, ta.PEAK_FLOPS_F32, ta.HBM_BW, ta.ICI_BW) == (
        989e12, 67e12, 3.35e12, 450e9)
    assert ta.DCN_BW < ta.ICI_BW


# ------------------------------------------------ wire factors, pods
def _hlo(kind: str, result: str, groups: str, extra: str = "") -> str:
    return ("ENTRY %main (p: f32[64]) -> f32[64] {\n"
            "  %p = f32[64]{0} parameter(0)\n"
            f"  ROOT %c = {result}{{0}} {kind}(%p){groups}{extra}\n}}\n")


HLO_CASES = {
    # the reference test's own snippet
    "all-reduce": (_hlo("all-reduce", "f32[64]",
                        ", replica_groups=[1,4]<=[4]", ", to_apply=%add"),
                   64 * 4, 4),
    "all-gather": (_hlo("all-gather", "f32[256]",
                        ", replica_groups=[1,4]<=[4]", ", dimensions={0}"),
                   256 * 4, 4),
    "reduce-scatter": (_hlo("reduce-scatter", "f32[16]",
                            ", replica_groups=[1,4]<=[4]",
                            ", dimensions={0}, to_apply=%add"), 16 * 4, 4),
    "all-to-all": (_hlo("all-to-all", "f32[64]",
                        ", replica_groups=[2,8]<=[16]", ", dimensions={0}"),
                   64 * 4, 8),
    "collective-permute": (_hlo("collective-permute", "bf16[64]", "",
                                ", source_target_pairs={{0,1},{1,0}}"),
                           64 * 2, 16),
}


@pytest.mark.parametrize("kind", list(HLO_CASES))
def test_wire_factors_equal_to_parse_collectives(kind):
    text, rbytes, n = HLO_CASES[kind]
    ref = ra.parse_collectives(text, 16)
    assert len(ref.ops) == 1
    got = ta.summarize_collectives([(kind, rbytes, n, False)])
    assert len(got.ops) == 1
    assert got.ops[0].kind == ref.ops[0].kind
    assert got.ops[0].bytes_result == ref.ops[0].bytes_result
    assert got.ops[0].group_size == ref.ops[0].group_size
    assert got.ops[0].wire_bytes_per_device == \
        ref.ops[0].wire_bytes_per_device
    assert got.total_wire_bytes == ref.total_wire_bytes
    assert got.by_kind() == ref.by_kind()


@pytest.mark.parametrize("groups,pods", [
    ("[1,512]<=[512]", True),            # the reference test's snippet
    ("[2,256]<=[512]", False),           # one group per pod
    ("[256,2]<=[2,256]T(1,0)", True),    # pairs across the pods
])
def test_cross_pod_classification_equal_to_parse_collectives(groups, pods):
    text = _hlo("all-reduce", "f32[64]", f", replica_groups={groups}",
                ", to_apply=%add")
    ref = ra.parse_collectives(text, 512, pod_size=256)
    assert ref.ops[0].cross_pod is pods
    for g in ra._parse_groups(text, 512):
        assert ta.crosses_pods(g.tolist(), 256) is (
            len({int(i) // 256 for i in g}) > 1)
    n = ref.ops[0].group_size
    got = ta.summarize_collectives([("all-reduce", 256, n, pods)])
    assert got.ops[0].cross_pod is ref.ops[0].cross_pod
    rate = ta.DCN_BW if pods else ta.ICI_BW
    assert got.seconds() == ref.ops[0].wire_bytes_per_device / rate
    assert not ta.crosses_pods(range(512), None)


# -------------------------------------------------------- the op counter
@pytest.fixture
def fake_group():
    """A fake process group of the asked size, destroyed after the test."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()

    def make(world):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


def _dt(mesh, shape, placements, fake):
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.dist import sharding as shd
    local, _ = compute_local_shape_and_global_offset(shape, mesh, placements)
    with fake:
        return shd.from_local(torch.empty(tuple(local)), mesh, placements,
                              shape)


def test_counter_sharded_product_is_rank_0s_share(fake_group):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    fake_group(256)
    mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data",
                                                             "model"))
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    a = _dt(mesh, (16384, 128), (Shard(0), Replicate()), fake)
    b = _dt(mesh, (128, 512), (Replicate(), Shard(1)), fake)
    counter = OpCounter(fake_mode=fake)
    with fake, counter:
        out = a @ b
    assert tuple(out.shape) == (16384, 512)
    assert counter.flops == 2 * 1024 * 128 * 32 == 8_388_608
    assert counter.flops_by_op == {"mm": 8_388_608}
    assert counter.collectives == []
    # operands and result of the local product, in bytes
    assert counter.bytes == (1024 * 128 + 128 * 32 + 1024 * 32) * 4


@pytest.mark.parametrize("n_products", [1, 3, 8])
def test_counter_python_loop_of_products(n_products):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(32, 48, generator=g)
    w = torch.randn(48, 48, generator=g)
    bias = torch.randn(48, generator=g)
    counter = OpCounter()
    with counter:
        for _ in range(n_products):
            x = torch.tanh(torch.addmm(bias, x, w))
        y = torch.bmm(x.view(4, 8, 48), w.expand(4, 48, 48))
    assert counter.flops == n_products * 2 * 32 * 48 * 48 + 2 * 4 * 8 * 48 * 48
    assert counter.flops_by_op == {"addmm": n_products * 2 * 32 * 48 * 48,
                                   "bmm": 2 * 4 * 8 * 48 * 48}
    assert y.shape == (4, 8, 48)


def test_counter_memory_peak_above_the_arguments():
    x = torch.zeros(1024)                     # 4096 B
    counter = OpCounter()
    with counter:
        counter.track_args(x)
        a = x + 1                             # 4096 live
        b = a * 2                             # 8192 live: the peak
        del a
        c = b.sum()                           # 4 B more, a freed
    assert counter.arg_bytes == 4096
    assert counter.temp_bytes == 8192
    assert counter.allocs_at_peak == 3       # x, a, b
    del b, c


COLLECTIVE_CASES = {
    # (mesh, src placements, dst placements, kind, result elements,
    #  group size, crosses pods)
    "all-gather": ((16, 16), ("S0", "R"), ("R", "R"), "all-gather",
                   256 * 64, 16, False),
    "all-reduce": ((16, 16), ("P", "R"), ("R", "R"), "all-reduce",
                   256 * 64, 16, False),
    "reduce-scatter": ((16, 16), ("R", "P"), ("R", "S0"), "reduce-scatter",
                       16 * 64, 16, False),
    "all-reduce across pods": ((2, 16, 16), ("P", "R", "R"),
                               ("R", "R", "R"), "all-reduce", 256 * 64, 2,
                               True),
    "all-gather within a pod": ((2, 16, 16), ("R", "S0", "R"),
                                ("R", "R", "R"), "all-gather", 256 * 64, 16,
                                False),
}


@pytest.mark.parametrize("case", list(COLLECTIVE_CASES))
def test_counter_collectives_exact(fake_group, case):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Partial, Replicate, Shard
    dims, src, dst, kind, elems, n, cross = COLLECTIVE_CASES[case]
    names = ("pod", "data", "model")[-len(dims):]
    fake_group(math.prod(dims))
    mesh = init_device_mesh("cpu", dims, mesh_dim_names=names)
    plc = {"S0": Shard(0), "R": Replicate(), "P": Partial()}
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    x = _dt(mesh, (256, 64), tuple(plc[p] for p in src), fake)
    counter = OpCounter(pod_size=256 if len(dims) == 3 else None,
                        fake_mode=fake)
    with fake, counter:
        y = x.redistribute(mesh, tuple(plc[p] for p in dst))
    assert counter.collectives == [(kind, elems * 4, n, cross)]
    assert counter.flops == 0
    assert tuple(y.to_local().shape) == ((16, 64) if kind == "reduce-scatter"
                                         else (256, 64))
    s = ta.summarize_collectives(counter.collectives)
    assert s.total_wire_bytes == ra.parse_collectives(
        _hlo(kind, f"f32[{elems}]",
             f", replica_groups=[1,{n}]<=[{n}]",
             ", dimensions={0}, to_apply=%add"), n).total_wire_bytes


def test_analyze_reads_the_counter():
    counter = OpCounter(pod_size=256)
    counter.flops, counter.bytes = 989e12, 3.35e12
    counter.collectives = [("all-reduce", 450e9 / 2, 2, False),
                           ("all-gather", 100e9, 2, True)]
    rf = ta.analyze(counter, 512, 989e12 * 512 / 2)
    assert rf.compute_s == 1.0 and rf.memory_s == 1.0
    assert rf.collective_s == 450e9 / 2 / ta.ICI_BW + 50e9 / ta.DCN_BW
    assert rf.coll_by_kind == {"ici/all-reduce": 450e9 / 2,
                               "dcn/all-gather": 50e9}
    assert rf.n_collectives == 2
    assert rf.hlo_total_flops_global == 989e12 * 512
    assert rf.compute_fraction == 0.5 / rf.step_time_s


# ------------------------------------------------------------ kernel bytes
def _pipeline_formula(c, n, ef, codec, reads):
    """The two kernels' launch structure, written out."""
    ops = 2 if ef else 1
    scratch = (2 * c * 2048 + c * 512 + 13 * c) * 4
    thresh = scratch + 2 * c * 4 + (c * 4 if codec else 0)
    for r in reads:
        thresh += r * ops * n * 4 + (2 * max(n // 8, 1) * 4 if r == 2 else 0)
    merge = ops * c * n * 4 + n * 4 + c * 8 + (c * 4 if codec else 0) + (
        c * n * 4 if ef else 0)
    return thresh, merge


@pytest.mark.parametrize("strategy,ef,codec", [
    ("topk", False, False), ("bcrs_opwa", False, False),
    ("eftopk", True, False), ("qtopk", True, True), ("int4", True, True)])
@pytest.mark.parametrize("c,n", [(8, 1 << 14), (5, 136_724), (3, 1001)])
def test_megakernel_bytes_follow_the_launch_structure(strategy, ef, codec, c,
                                                      n):
    reads = [2] * c
    b = kb.megakernel_hbm_bytes(c, n, strategy)
    thresh, merge = _pipeline_formula(c, n, ef, codec, reads)
    assert (b["threshold"], b["merge"]) == (thresh, merge)
    assert b["total"] == thresh + merge
    assert b["passes"] == (thresh + merge) / (c * n * 4)
    reads = [3] + [2] * (c - 1)
    b3 = kb.megakernel_hbm_bytes(c, n, strategy, reads)
    assert b3["threshold"] == _pipeline_formula(c, n, ef, codec, reads)[0]
    assert b3["threshold"] > b["threshold"]


def test_megakernel_bytes_refuse_what_is_not_the_pipeline():
    with pytest.raises(ValueError, match="megakernel=False"):
        kb.megakernel_hbm_bytes(8, 1024, "fedavg")
    with pytest.raises(ValueError, match="reads"):
        kb.megakernel_hbm_bytes(2, 1024, "topk", reads=[2, 4])


@pytest.mark.parametrize("strategy", ["bcrs_opwa", "eftopk"])
def test_merge_traffic_ratio_at_least_3(strategy):
    from repro_torch.fed.engine import ClientUpdateSpec
    spec = ClientUpdateSpec(strategy=strategy, gamma=5.0, use_kernel=False)
    r = kb.merge_traffic_ratio(spec, 8, 1 << 13)
    assert r["ratio"] >= 3.0, r
    assert r["unfused"]["total"] == kb.unfused_merge_bytes(
        spec, 8, 1 << 13)["total"]


def test_unfused_merge_bytes_refuse_the_kernel_route():
    from repro_torch.fed.engine import ClientUpdateSpec
    with pytest.raises(ValueError, match="plain route"):
        kb.unfused_merge_bytes(ClientUpdateSpec(strategy="topk",
                                                use_kernel=True), 2, 64)


def _non_dense():
    from repro_torch.core import strategies
    return [s for s in strategies.names() if not strategies.get(s).wire.dense]


@pytest.mark.parametrize("strategy", _non_dense())
@pytest.mark.parametrize("n,k", [(136_724, 13_672), (1 << 20, 1), (1001, 50)])
def test_wire_stream_bytes_equal_to_the_reference(strategy, n, k):
    assert kb.wire_stream_bytes(strategy, n, k) == rkb.wire_stream_bytes(
        strategy, n, k)


def test_wire_stream_bytes_refuse_dense():
    with pytest.raises(ValueError, match="dense"):
        kb.wire_stream_bytes("fedavg", 1024, 10)


# the bound counts, against the expressions chip_smoke.py wrote by hand
MAIN, LEAF, WUP = (5, 136_724), (8, 2048 * 5632), (8, 24 * 2048 * 5632)


@pytest.mark.parametrize("c,n", [MAIN, LEAF, WUP, (4, WUP[1]), (3, 1001)])
@pytest.mark.parametrize("ef", [False, True])
def test_merge_bound_counts(c, n, ef):
    elems = c * n
    assert kb.threshold_find_bound(c, n, ef) == (
        elems * 4 * (1 + int(ef)) + c * 4 * 2, elems)
    assert kb.fused_merge_bound(c, n, ef) == (
        elems * 4 * (1 + 2 * int(ef)) + n * 4 + c * 8,
        elems * (3 + 2 * int(ef)))
    assert kb.overlap_combine_bound(c, n) == (c * n * 5 + n * 4 + c * 4,
                                              c * n * 3 + n)


@pytest.mark.parametrize("nb,block", [(17, 8192), (1408, 8192), (8, 32768),
                                      (4, 262144), (2, 1000)])
def test_row_bound_counts(nb, block):
    elems = nb * block
    assert kb.block_topk_bound(nb, block) == (elems * 9, elems * 9)
    assert kb.ef_update_bound(nb, block) == (elems * 16, elems * 11)


@pytest.mark.parametrize("b,h,sq,sk,d,esize,causal", [
    (4, 32, 2048, 2048, 64, 4, True), (4, 32, 2048, 2048, 64, 2, True),
    (1, 32, 32768, 32768, 128, 2, True), (2, 8, 700, 1000, 64, 4, True),
    (2, 8, 1000, 700, 64, 4, True), (2, 8, 384, 384, 32, 2, False)])
def test_flash_bound_counts(b, h, sq, sk, d, esize, causal):
    def causal_pairs(sq, sk, causal):        # chip_smoke.py's, as it was
        if not causal:
            return sq * sk
        n = min(sq, sk)
        return n * (n + 1) // 2 + max(0, sq - sk) * sk
    assert kb.causal_pairs(sq, sk, causal) == causal_pairs(sq, sk, causal)
    assert kb.flash_bound(b, h, sq, sk, d, esize, causal) == (
        4 * b * h * sq * d * esize, 4 * b * h * causal_pairs(sq, sk, causal)
        * d)


@pytest.mark.parametrize("nbytes,ops,rate", [
    (136_724 * 5 * 4 + 40, 136_724 * 5, 67e12),
    (10, 10 ** 9, 67e12), (4 * 32 * 2048 * 64 * 2, 4 * 32 * 2098176 * 64,
                           989e12), (0, 0, 67e12)])
def test_bound_ms(nbytes, ops, rate):
    ms, by = kb.bound_ms(nbytes, ops, rate)
    bound_bytes = nbytes / 3.35e12 * 1e3
    bound_ops = ops / rate * 1e3
    assert ms == max(bound_bytes, bound_ops)
    assert by == ("bytes" if bound_bytes >= bound_ops else "operations")
    assert max(nbytes / 3.35e12, ops / rate) * 1e3 == ms


def _decode_bytes_by_hand(model, params, batch, positions, cache_len=None):
    """chip_smoke.decode_bound_ms's byte count, as it was written there."""
    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(t) for t in tree.values())
        return tree.numel() * tree.element_size()
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
    total = weights + kv + cross + 2 * state + batch * model.v_pad * 2
    return total, state


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "hymba-1.5b", "rwkv6-1.6b",
                                  "whisper-medium", "llama-3.2-vision-11b",
                                  "deepseek-v3-671b"])
def test_decode_step_bytes(arch):
    from repro_torch.models import Model
    cfg = tc.get_config(arch).reduced()
    model = Model(cfg, device="cpu")
    params = model.init(0)
    for batch, positions, cache_len in ((4, 144, 32), (1, 0, 8)):
        assert kb.decode_step_bytes(model, params, batch, positions,
                                    cache_len) == _decode_bytes_by_hand(
            model, params, batch, positions, cache_len)


# ------------------------------------------------------------------- flags
def test_flags_are_the_references_names():
    assert tflags.COST_EXACT is False is ref_flags.COST_EXACT
    for length in (1, 7, 61):
        assert tflags.scan_unroll(length) == ref_flags.scan_unroll(length) \
            == 1
    assert {n for n in dir(tflags) if not n.startswith("_")} >= {
        "COST_EXACT", "scan_unroll"}


def test_dataclasses_match():
    assert [f.name for f in dataclasses.fields(ta.Roofline)] == [
        f.name for f in dataclasses.fields(ra.Roofline)]
    assert [f.name for f in dataclasses.fields(ta.CollectiveOp)] == [
        f.name for f in dataclasses.fields(ra.CollectiveOp)]
