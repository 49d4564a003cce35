"""flash_attention: causal (or full) forward attention with online softmax
over heads-flattened ``[BH, S, D]`` tensors.

Port of ``repro.kernels.flash_attention.flash_attention_pallas``. Per query
row, over blocks of ``blk_k`` keys: ``q`` is cast to f32 and scaled by
``1/sqrt(D)`` BEFORE the dot product; scores where ``q_pos < k_pos`` become
-1e30 (causal, positions aligned at the top left when Sq != Sk); the running
max ``m``, denominator ``l`` and accumulator ``acc`` are f32; the output is
``acc / max(l, 1e-30)`` in q's dtype.

Two hand-written Hopper kernels, each with its plain PyTorch twin:

  * ``flash_attention_cuda``: ``csrc/flash_attention.cu``, f32 on the CUDA
    cores, for f32 and bf16 and D in ``HEAD_DIMS``: one CTA per (bh, 128
    query rows), a producer warp streaming K and V tiles of 64 keys through
    a shared-memory ring on mbarriers (cp.async), eight warps each owning
    16 query rows (8 x 4 score micro-tiles, P through a per-warp slice),
    the mask only on tiles that cross the diagonal or Sk. Its twin
    ``flash_attention_plain`` runs the same blockwise online softmax
    vectorised over BH and the query rows. The CPU tests hold the twin to
    the Pallas kernel and to an f64 sum; ``chip_smoke.py`` holds the kernel
    to the twin;
  * ``flash_attention_wgmma_cuda``: ``csrc/flash_attention_wgmma.cu``, bf16
    on the tensor cores (``wgmma``, K and V streamed by TMA), D in
    ``WGMMA_HEAD_DIMS``; it must round P to bf16 for the PV product, and
    its twin ``flash_attention_wgmma_plain`` rounds where it rounds. The two
    are held to each other, and the twin to the reference, within the
    bound ``wgmma_twin_and_bound`` computes from the twin's own weights.

The f32 kernel sums in another order than its twin (its own key tiles of
64, its own dot-product order), so the two agree within a stated bound,
not bit for bit: ``f32_twin_bound`` computes, per element and in f64 from
the inputs, how far two f32 evaluations that sum keys in tiles (of 64 and
of ``blk_k``) may lie apart (derived in ``csrc/flash_attention.cu``:
the dot products' order, expf, the alphas, the within- and across-tile
sums of l and acc). bf16 outputs within that plus one bf16 ULP of the
larger of the two, as each side rounds its own f32 result (and the bf16
kernel's output is the f32 kernel's on the upcast inputs, rounded).

``flash_attention`` picks by the tensor's device: ``flash_attention_plain``
for CPU tensors; for CUDA tensors the wgmma kernel when the inputs are bf16
with D in ``WGMMA_HEAD_DIMS``, Sq % 128 == 0 and Sk % 64 == 0 (what
``ops.flash_attention`` gives at its default blocks), else
``flash_attention_cuda``. A kernel launches or raises: there is no
fallback, to the other kernel or to a twin. Each kernel counts its own
launches (``flash_attention.launches``,
``flash_attention_wgmma_cuda.launches``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
#: head dims the kernel is built for
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the f32 kernel's key tile (csrc/flash_attention.cu)
FA_BK = 64
#: f32 round-to-nearest unit roundoff
U_F32 = 2.0 ** -24
#: head dims of the wgmma kernel, its query tile, and the multiple of 64
#: keys it takes (its own key tile is ``wgmma_bk(D)``; a last tile of 64
#: keys at D 64 is masked past Sk)
WGMMA_HEAD_DIMS = (64, 128)
WGMMA_BQ, WGMMA_BK = 128, 64
#: stages of the wgmma kernel's K / V ring in shared memory
WGMMA_STAGES = 4
#: an f32 add on the tensor cores at its worst (truncation): one ulp
U_SUM = 2.0 ** -23
#: p below this carries no relative guarantee (bf16 denormals, and the
#: kernel's exp2 flushes results below 2^-126 to zero); such keys are held
#: by an absolute term instead
TINY_P = 2.0 ** -100
LN2 = math.log(2.0)


def wgmma_bk(d: int) -> int:
    """The wgmma kernel's key tile: 128 keys at D 64, 64 at D 128
    (``csrc/flash_attention_wgmma.cu``, ``Cfg::BK``)."""
    return 128 if d == 64 else 64


def wgmma_scale_log2(d: int) -> float:
    """The wgmma route's score factor, 1/sqrt(D) * log2(e) rounded once to
    f32: both the kernel and its twin take exp2 of scores in log2 units."""
    return float(torch.tensor(1.0 / (LN2 * d ** 0.5), dtype=torch.float32))


def dot_u(d: int) -> float:
    """Relative bound on the difference of two f32 dot products of length
    d of the same bf16 operands, times sum |q_i k_i|: the tensor cores'
    (a k-step of 16 adds 17 terms, each may lose an ulp of the largest)
    plus a round-to-nearest GEMM's (half an ulp an add), plus the scale's
    product on each side."""
    return (17 * d / 16 + d / 2 + 4) * U_SUM


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, blk_q: int = 128,
                          blk_k: int = 128) -> torch.Tensor:
    """Plain PyTorch twin (any device). Same arguments and result as
    ``flash_attention``."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    assert sq % blk_q == 0 and sk % blk_k == 0
    scale = 1.0 / (d ** 0.5)
    qf = q.float() * scale
    q_pos = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((bh, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((bh, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((bh, sq, d), dtype=torch.float32, device=q.device)
    for i in range(sk // blk_k):
        kb = k[:, i * blk_k:(i + 1) * blk_k].float()
        vb = v[:, i * blk_k:(i + 1) * blk_k].float()
        s = qf @ kb.transpose(1, 2)                      # [BH, Sq, blk_k]
        if causal:
            k_pos = i * blk_k + torch.arange(blk_k, device=q.device)[None, :]
            s = torch.where(q_pos >= k_pos, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + p @ vb
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)


def f32_twin_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, blk_k: int = 128) -> torch.Tensor:
    """Elementwise f64 bound [BH, Sq, D] on how far two f32 evaluations of
    ``flash_attention`` on these inputs may lie apart before any rounding
    of the output to bf16 (add one bf16 ULP of the larger of the two for
    that): one summing keys in tiles of ``FA_BK`` by sequential FMAs (the
    kernel), the other in tiles of ``blk_k`` by matmuls in any order (the
    twin). Derived in ``csrc/flash_attention.cu``; computed here from the
    inputs by an f64 blockwise recurrence (exact weights w_j, output o,
    S = sum_j w_j |v_j|, the prefix sums the alphas carry), never from
    either side's output, so a side that drops or repeats a key tile gets
    no room from it."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    dev, f64, u = q.device, torch.float64, U_F32
    qs = (q.float() * (1.0 / (d ** 0.5))).to(f64)   # both sides' scaled q
    qa = qs.abs()
    kd, vd = k.to(f64), v.to(f64)
    gam = d * u / (1 - d * u)
    # a tile may move the running max on either side when its max is
    # within 2 gamma_D max_j A_j of it (A_j <= |q| max|k|, Cauchy-Schwarz)
    a_cs = qs.norm(dim=-1) * kd.norm(dim=-1).amax(dim=1, keepdim=True)
    tol = 2 * gam * a_cs
    zero = lambda *s: torch.zeros(s, dtype=f64, device=dev)   # noqa: E731
    m = torch.full((bh, sq), -torch.inf, dtype=f64, device=dev)
    l, x0, y0, changes = (zero(bh, sq) for _ in range(4))
    acc, s_abs, x1, y1, z = (zero(bh, sq, d) for _ in range(5))
    m_first = m_first_twin = None
    for k0 in range(0, sk, FA_BK):
        k1 = min(sk, k0 + FA_BK)
        r0 = k0 if causal else 0      # causal: earlier rows see none of it
        if r0 >= sq:
            break
        kt, va = kd[:, k0:k1], vd[:, k0:k1].abs()
        s = qs[:, r0:] @ kt.transpose(1, 2)              # [BH, rows, keys]
        a = qa[:, r0:] @ kt.abs().transpose(1, 2)
        if causal:
            valid = (torch.arange(r0, sq, device=dev)[:, None]
                     >= torch.arange(k0, k1, device=dev)[None, :])
            s = s.masked_fill(~valid, -torch.inf)
        t_max = s.amax(dim=-1)
        mo = m[:, r0:]
        m_new = torch.maximum(mo, t_max)
        p = torch.exp(s - m_new[..., None])
        gap = torch.where(p > 0, m_new[..., None] - s, 0.0)   # M - s_j >= 0
        if k0 == 0:
            m_first = t_max
            m_first_twin = (t_max if blk_k >= FA_BK
                            else s[..., :blk_k].amax(dim=-1))
            alpha = torch.zeros_like(t_max)
            dm = torch.zeros_like(t_max)
        else:
            changes[:, r0:] += (t_max >= mo - tol[:, r0:]).to(f64)
            dm = m_new - mo
            alpha = torch.exp(-dm)
        al = alpha[..., None]
        z[:, r0:] = al * (z[:, r0:] + acc[:, r0:].abs())
        x1[:, r0:] = al * (x1[:, r0:] + dm[..., None] * s_abs[:, r0:]) + (
            p * gap) @ va
        x0[:, r0:] = alpha * (x0[:, r0:] + dm * l[:, r0:]) + (
            p * gap).sum(dim=-1)
        y1[:, r0:] = al * y1[:, r0:] + (p * a) @ va
        y0[:, r0:] = alpha * y0[:, r0:] + (p * a).sum(dim=-1)
        s_abs[:, r0:] = al * s_abs[:, r0:] + p @ va
        acc[:, r0:] = al * acc[:, r0:] + p @ vd[:, k0:k1]
        l[:, r0:] = alpha * l[:, r0:] + p.sum(dim=-1)
        m[:, r0:] = m_new
    lc = l[..., None]
    o = acc / lc
    oa = o.abs()
    S = s_abs / lc
    X = (x1 + oa * x0[..., None]) / lc
    Y = (y1 + oa * y0[..., None]) / lc
    zn = z / lc
    n_k, n_t = -(-sk // FA_BK), -(-sk // blk_k)
    if blk_k % FA_BK == 0:           # the twin's changes and tile starts
        c_twin, z_twin = changes, zn  # are among the kernel's
    else:
        c_twin = torch.minimum(changes * (FA_BK // blk_k + 2),
                               torch.full_like(changes, n_t - 1))
        z_twin = (n_t - 1) * S
    eta_k = 4 * u * (1 + changes) + u * (m - m_first)
    eta_t = 4 * u * (1 + c_twin) + u * (m - m_first_twin)
    weights = 2 * gam * Y + (eta_k + eta_t)[..., None] * (S + oa) + 2 * u * X
    sums = u * (65 * zn + 2 * z_twin + (blk_k + 66) * S)
    l_sums = u * (9 + 2 * n_k + blk_k + 2 * n_t) * oa
    vmax = vd.abs().amax(dim=1, keepdim=True)
    tiny = 2 * sk * 2.0 ** -148 * (vmax + oa)
    delta = (gam * a_cs + torch.maximum(eta_k, eta_t) + 2.0 ** -17)[..., None]
    return ((weights + sums + l_sums + tiny) * (1 + delta) / (1 - delta)
            * (1 + 2.0 ** -10))


def _wgmma_recurrence(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool, both_round: Optional[bool]):
    """The twin's arithmetic; with ``both_round`` set, also the sums over
    the twin's own weights that ``wgmma_twin_and_bound`` needs."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    assert sk % WGMMA_BK == 0
    scale = 1.0 / (d ** 0.5)
    c = wgmma_scale_log2(d)
    bk = wgmma_bk(d)
    dev = q.device
    qf = q.float()
    q_pos = torch.arange(sq, device=dev)[:, None]
    m = torch.full((bh, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((bh, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((bh, sq, d), dtype=torch.float32, device=dev)
    carry = None
    if both_round is not None:
        # ds: the score difference between the two sides, per row
        kmax = k.float().norm(dim=-1).amax(dim=1, keepdim=True)   # [BH, 1]
        ds = dot_u(d) * scale * qf.norm(dim=-1) * kmax             # [BH, Sq]
        z = torch.zeros_like(acc)          # sum of |acc| a summed tile sees
        s_abs = torch.zeros_like(acc)      # sum_j p^_j |v_j| (alphas on)
        f_abs = torch.zeros_like(acc)      # the same over keys that flip
        f_one = torch.zeros_like(l)        # sum of p^_j over those keys
        changes = torch.zeros_like(l)      # tiles that may move m
        m_first = None
    for k0 in range(0, sk, bk):
        kb = k[:, k0:k0 + bk].float()
        vb = v[:, k0:k0 + bk].float()
        s = (qf @ kb.transpose(1, 2)) * c           # log2 units
        if causal:
            k_pos = k0 + torch.arange(kb.shape[1], device=dev)[None, :]
            s = torch.where(q_pos >= k_pos, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp2(s - m_new[..., None])
        pb = p.to(torch.bfloat16).float()
        alpha = torch.exp2(m - m_new)
        if both_round is not None:
            live = ((q_pos >= k0).expand(bh, sq, 1) if causal
                    else torch.ones((bh, sq, 1), dtype=torch.bool,
                                    device=dev))
            va = vb.abs()
            z = torch.where(live, alpha[..., None] * (z + acc.abs())
                            + pb @ va, z)
            s_abs = s_abs * alpha[..., None] + pb @ va
            if both_round:
                # the other side's p lies within p * e^(+-r) before its
                # bf16 rounding; a rounding boundary inside means a flip
                # (natural units: a log2-unit difference counts ln 2 times)
                r = (2 * ds[..., None] + 2.0 ** -21
                     + LN2 * (2.0 ** -23 * (m_new[..., None] - s)
                              + 2.0 ** -24 * s.abs()) + 2.0 ** -19)
                flip = ((p * (1 - r)).to(torch.bfloat16)
                        != (p * (1 + r)).to(torch.bfloat16)) & (p >= TINY_P)
                fp = pb * flip
                f_abs = f_abs * alpha[..., None] + fp @ va
                f_one = f_one * alpha + fp.sum(dim=-1)
            if m_first is None:
                m_first = m_new
            else:
                changes += (s.amax(dim=-1) >= m - 2 * ds / LN2).float()
        l = l * alpha + pb.sum(dim=-1)
        acc = acc * alpha[..., None] + pb @ vb
        m = m_new
    o = acc / torch.clamp_min(l, 1e-30)[..., None]
    if both_round is not None:
        carry = dict(ds=ds, z=z, s_abs=s_abs, f_abs=f_abs, f_one=f_one,
                     changes=changes, m_span=LN2 * (m - m_first),
                     m_abs=LN2 * torch.maximum(m.abs(), m_first.abs()), l=l)
    return o, carry


def flash_attention_wgmma_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, causal: bool = True
                                ) -> torch.Tensor:
    """Plain PyTorch twin of the wgmma kernel (any device), bf16 in and out:
    per key tile of ``wgmma_bk(D)``, scores in log2 units, ``s = (q . k) * c``
    in f32 (``c = wgmma_scale_log2(D)``, after the dot product, as the
    kernel applies it), the -1e30 causal mask, the reference's m / l /
    alpha recurrence with exp2 for exp, P rounded to bf16 before it enters
    both ``l`` and the PV product, the output rounded to bf16."""
    return _wgmma_recurrence(q, k, v, causal, None)[0].to(torch.bfloat16)


def wgmma_twin_and_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, both_round: bool = True):
    """The twin's output (``flash_attention_wgmma_plain``'s, bit for bit)
    and an elementwise f64 bound [BH, Sq, D] on how far another output of
    the same function may lie from it before each side rounds its output
    to bf16 (add one bf16 ULP of the larger of the two for that).
    ``both_round``: the other side rounds P to bf16 as well (the kernel);
    False: it keeps P in f32 (the reference, the f32 twin).

    Derived in ``csrc/flash_attention_wgmma.cu``: per row, with w_j the
    twin's own softmax weights, S = sum_j w_j |v_j|, F = the same sum over
    the keys whose bf16 rounding of p may differ between the two sides
    (both_round; a rounding boundary lies within p's uncertainty), F1 their
    weight, Z/l the tiles' running |acc| and eta the relative change every
    weight may take besides its rounding (score order, the alpha chain):
    ``(eta (S + |o|) + 2^-7 (1 + 2^-7) (F + F1 |o|)) / (1 - delta)`` (or
    ``2^-8 (1 + 2^-7) (S + |o|)`` in place of the flip term when only the
    twin rounds), plus the two sides' f32 sums on the tensor cores' worst
    case, ``2 * 17 * (BK / 16) * u * Z / l + (2 Sk / BK + 2 * 17 * (BK / 16)
    + 4) u |o|`` with BK = ``wgmma_bk(D)``."""
    o, cr = _wgmma_recurrence(q, k, v, causal, bool(both_round))
    sk = k.shape[1]
    bk = wgmma_bk(q.shape[2])
    n_kt = -(-sk // bk)
    l = cr["l"].double().clamp_min(1e-30)[..., None]
    oa = o.double().abs()
    s_abs, z = cr["s_abs"].double() / l, cr["z"].double() / l
    eta = (cr["ds"].double() + cr["changes"].double() * 2.0 ** -20
           + 2.0 ** -23 * cr["m_span"].double())[..., None]
    if both_round:
        rounding = 2.0 ** -7 * (1 + 2.0 ** -7) * (
            cr["f_abs"].double() / l + cr["f_one"].double()[..., None]
            / l * oa)
        delta = eta + 2.0 ** -7 * (1 + 2.0 ** -7)
    else:
        # p's exp2 and subtraction (p >= 2^-100: m - s <= 70 natural), the
        # twin's rounded product s = (q . k) c (|s| <= |m| + 70)
        eta = (eta + 2.0 ** -21 + 70 * 2.0 ** -23
               + 2.0 ** -24 * (cr["m_abs"].double() + 70)[..., None])
        rounding = 2.0 ** -8 * (1 + 2.0 ** -7) * (s_abs + oa)
        delta = eta + 2.0 ** -8 * (1 + 2.0 ** -7)
    weights = (eta * (s_abs + oa) + rounding) / (1 - delta)
    steps = 17 * (bk // 16)       # a tile's k-steps lose 17 ulps each
    sums = ((2 * steps * U_SUM * z + (2 * n_kt + 2 * steps + 4) * U_SUM * oa)
            * (1 + delta) / (1 - delta))
    vmax = v.double().abs().amax(dim=1, keepdim=True)
    tiny = sk * 2.0 ** -99 * (vmax + oa)
    return (o.to(torch.bfloat16),
            (weights + sums + tiny) * (1 + 2.0 ** -10))


def takes_wgmma(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Whether the wgmma kernel takes these inputs: bf16, D in
    ``WGMMA_HEAD_DIMS``, Sq a multiple of 128 and Sk of 64."""
    return (q.dtype == torch.bfloat16 and q.dim() == 3
            and q.shape[2] in WGMMA_HEAD_DIMS
            and q.shape[1] % WGMMA_BQ == 0 and k.shape[1] % WGMMA_BK == 0)


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 blk_q: int, blk_k: int) -> None:
    """What the kernel takes: contiguous, 16-byte aligned ``[BH, S, D]``
    CUDA tensors of one dtype (f32 or bf16), D in HEAD_DIMS, k and v of one
    shape, Sq and Sk multiples of the blocks (the reference's assertion)."""
    if q.device.type != "cuda" or q.dim() != 3 or q.dtype not in DTYPES:
        raise ValueError("flash_attention_cuda: q must be a [BH, Sq, D] f32 "
                         "or bf16 CUDA tensor")
    bh, sq, d = q.shape
    for name, t in (("k", k), ("v", v)):
        if (t.device != q.device or t.dtype != q.dtype or t.dim() != 3
                or t.shape[0] != bh or t.shape[2] != d
                or t.shape != k.shape):
            raise ValueError(f"flash_attention_cuda: {name} must be "
                             f"[{bh}, Sk, {d}] {q.dtype} on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention_cuda: {name} must be "
                             "contiguous and 16-byte aligned")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {d} not in "
                         f"{HEAD_DIMS}")
    sk = k.shape[1]
    if bh == 0 or sq == 0 or sk == 0 or sq % blk_q or sk % blk_k:
        raise ValueError(f"flash_attention_cuda: Sq={sq}, Sk={sk} must be "
                         f"positive multiples of blk_q={blk_q}, "
                         f"blk_k={blk_k} (ops.flash_attention pads)")


def _flash_lib():
    fn = build.library("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, blk_q: int = 128,
                         blk_k: int = 128) -> torch.Tensor:
    """Launch the Hopper kernel on CUDA tensors (raises on anything the
    kernel does not take). ``blk_q``/``blk_k`` only fix the divisibility the
    reference asserts; the kernel tiles by its own 128 query rows and 64
    keys."""
    check_inputs(q, k, v, blk_q, blk_k)
    bh, sq, d = q.shape
    fn = _flash_lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 bh, sq, k.shape[1], d, DTYPES[q.dtype], int(bool(causal)),
                 1.0 / (d ** 0.5), stream)
    build.check(err, "flash_attention")
    build.count_launch(flash_attention)
    return out


def _flash_wgmma_lib():
    fn = build.library("flash_attention_wgmma").flash_attention_wgmma_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_float,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_wgmma_cuda(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool = True
                               ) -> torch.Tensor:
    """Launch the wgmma kernel on bf16 CUDA tensors (raises on anything it
    does not take)."""
    check_inputs(q, k, v, WGMMA_BQ, WGMMA_BK)
    if not takes_wgmma(q, k):
        raise ValueError("flash_attention_wgmma_cuda: needs bf16 with D in "
                         f"{WGMMA_HEAD_DIMS}; got {q.dtype}, D={q.shape[2]}")
    bh, sq, d = q.shape
    fn = _flash_wgmma_lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 bh, sq, k.shape[1], d, int(bool(causal)),
                 wgmma_scale_log2(d), stream)
    build.check(err, "flash_attention_wgmma")
    build.count_launch(flash_attention_wgmma_cuda)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, causal: bool = True, blk_q: int = 128,
                    blk_k: int = 128) -> torch.Tensor:
    """q: [BH, Sq, D]; k, v: [BH, Sk, D] (heads pre-flattened), f32 or
    bf16; Sq % blk_q == 0 and Sk % blk_k == 0 (pad in ``ops``).

    Returns [BH, Sq, D] in q's dtype. CPU tensors take the plain twin
    ``flash_attention_plain``. CUDA tensors go to the wgmma kernel when
    ``takes_wgmma`` (bf16, D in ``WGMMA_HEAD_DIMS``, Sq % 128 == 0,
    Sk % 64 == 0), counted in ``flash_attention_wgmma_cuda.launches``, and to
    ``flash_attention_cuda`` otherwise (f32, other head dims, other
    blocks), counted in ``flash_attention.launches``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, blk_q=blk_q,
                                     blk_k=blk_k)
    check_inputs(q, k, v, blk_q, blk_k)
    if takes_wgmma(q, k):
        return flash_attention_wgmma_cuda(q, k, v, causal=causal)
    return flash_attention_cuda(q, k, v, causal=causal, blk_q=blk_q,
                                blk_k=blk_k)


#: kernel launches (one per call that reaches csrc/flash_attention.cu)
flash_attention.launches = 0
#: kernel launches (one per call that reaches csrc/flash_attention_wgmma.cu)
flash_attention_wgmma_cuda.launches = 0
