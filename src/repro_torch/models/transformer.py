"""Models: init, the training loss, prefill and cached decode.

Port of ``repro.models.transformer.Model`` for six families:
  * dense (stablelm, yi, qwen: MHA or GQA, optional QKV bias);
  * moe (deepseek-v3: MLA attention, leading dense blocks, then blocks
    whose FFN is a routed MoE with a shared expert, and an MTP head; kimi-k2:
    the same with GQA attention and no MTP);
  * hybrid (hymba: GQA sliding-window attention and a parallel SSD branch,
    mixed as ``0.5 * (rms_norm(a) + rms_norm(s))``);
  * ssm (rwkv6: time-mix and channel-mix blocks behind a layer norm);
  * encdec (whisper: a bidirectional encoder over precomputed frame
    embeddings ``batch["frames"]`` [B, S_enc, d], then decoder blocks of
    causal self-attention, cross-attention to the encoder's output and an
    MLP; sinusoidal positions, no RoPE);
  * vlm (llama-3.2-vision: G groups of ``per`` dense self-attention blocks
    and one gated cross-attention block to the projected patch embeddings
    ``batch["patches"]`` [B, n_patches, d_vision]);
each with ``init``, ``loss_fn``, ``init_cache``, ``decode_step`` and
``prefill``. The frontends are stubs, as in the reference: frames and
patches come precomputed.
Params are nested dicts whose layer stacks carry a leading ``[L, ...]``
axis (vlm's self blocks ``[G, per, ...]``); the forward walks them with a
Python loop. Under autograd each block (encoder, decoder, self and cross
blocks alike) is checkpointed as ``cfg.remat`` says (``_remat``: "full",
"dots" or "none"), as the reference wraps its scanned blocks; with grad
mode off (serving) no block is. The caches are stacked ``[L, ...]`` too and
written in place by ``decode_step``: ``{"k", "v"}`` of ``[L, B, S, Hkv,
D]``, for hybrid also ``"ssm": {"conv", "state"}``, for ssm ``{"tm_x",
"cm_x", "wkv"}``, for encdec also ``{"ck", "cv"}`` of ``[L, B, S, Hkv,
D]``, for vlm ``{"k", "v"}`` of ``[G, per, B, S, Hkv, D]`` and ``{"ck",
"cv"}`` of ``[G, B, n_patches, Hkv, D]``, for MLA ``{"mla": {"c_kv",
"k_rope"}}`` of ``[L, B, S, kv_lora_rank]`` and ``[L, B, S, rope_dim]``.
As in the reference, nothing fills the cross caches: ``init_cache`` gives
zeros and ``prefill`` returns no cache, so serving decodes without the
audio or the image (ROADMAP §3, R5).

Under sharding rules (``dist.sharding``) the model pins layouts where the
reference does: the embedded tokens and the final hidden states
``("batch", "seq", "embed")``, each block's output ``("batch", None,
"act_d")``, the logits ``("batch", "seq", "vocab")`` (decode: ``("batch",
"vocab")``); embedding lookups become the one-hot contraction. Without
rules every ``constrain`` is the identity. ``init(seed, placer=)`` draws
the same stream and keeps only this rank's share of each leaf, one layer
at a time (``sharding.Placer``); ``abstract_params`` gives the tree's
shapes and dtypes as meta tensors, with no allocation.

A sliding ``window`` (with its ``global_layers``) is honoured per layer, as
in the reference. A family the port does not run raises
``NotImplementedError`` when the model is built.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import (constrain, gather_batch_axes,
                                      get_rules)
from repro_torch.models import attention as attn
from repro_torch.models import mamba, mla, moe, rwkv6
from repro_torch.models.layers import (_dtype, apply_mlp, cross_entropy,
                                       dense_init, embed_init, embed_lookup,
                                       embed_onehot, init_mlp, layer_norm,
                                       pad_vocab, rms_norm)
from repro_torch.tree import tree_from_items, tree_items

Params = Dict[str, Any]


def _save_mm(ctx, op, *args, **kwargs):
    """The "dots" policy: keep what ``aten.mm`` computes, recompute the
    rest. ``x @ W`` with a 2-D weight folds to ``mm``, so this keeps the
    products with no batch dimension, as the reference's
    ``dots_with_no_batch_dims_saveable``; attention's and GLA's batched
    products (``bmm``) are recomputed."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, mode: str):
    """``fn`` checkpointed as the reference's ``_remat``: "none" returns it
    unchanged, "dots" keeps the matmul outputs (``_save_mm``) and any
    other mode recomputes the whole block in the backward. Non-reentrant,
    so ``torch.autograd.grad`` works through it; no RNG state (nothing
    draws randomness, and saving it would read the generator inside a CUDA
    graph capture). A recompute runs the same ops on the same inputs, so
    the three modes give the same bits. Under sharding rules the block's
    params are gathered over the batch axes first, inside the checkpointed
    region (``gather_batch_axes``: FSDP's per-layer gather, redone in the
    recompute)."""
    if get_rules() is not None:
        fn = _gathered(fn)
    if mode == "none":
        return fn
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if mode == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_mm)
    return functools.partial(checkpoint, fn, **kw)


def _gathered(fn):
    """``fn(p, ...)`` with ``p`` gathered over the batch axes first."""
    @functools.wraps(fn)
    def run(p, *args, **kw):
        return fn(gather_batch_axes(p), *args, **kw)
    return run


def layer_params(tree, i: int):
    """Layer ``i`` of a stacked ``[L, ...]`` params tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


def unstack_layers(tree, n: int):
    """A stacked ``[L, ...]`` params tree -> L per-layer trees, each leaf
    unbound once (views). Under autograd each stacked leaf then gets one
    backward that stacks the L layer gradients, where indexing layer by
    layer (``layer_params``) would give each layer's gradient as a
    zero-filled full ``[L, ...]`` tensor to be summed L times."""
    if isinstance(tree, dict):
        per_key = {k: unstack_layers(v, n) for k, v in tree.items()}
        return [{k: per_key[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _stack(trees):
    """List of per-layer params trees -> one tree with a leading L axis
    (one layer: a view of it, no copy, so that a full-width MoE layer is
    not held twice while it is stacked)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if len(trees) == 1:
        return first.unsqueeze(0)
    return torch.stack(trees)


def sinusoidal_pos(seq: int, d: int, offset=0, device=None) -> torch.Tensor:
    """f32 [seq, d] sinusoidal positions from ``offset``, in the
    reference's order: ``sin(pos * div)`` in the even columns, ``cos`` in
    the odd, ``div = exp(arange(0, d, 2) * (-log(10000) / d))``."""
    f32 = torch.float32
    pos = offset + torch.arange(seq, device=device)[:, None].to(f32)
    c = -torch.log(torch.tensor(10000.0, dtype=f32, device=device)) / d
    div = torch.exp(torch.arange(0, d, 2, dtype=f32, device=device) * c)
    pe = torch.zeros((seq, d), dtype=f32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


#: the families the port runs, each with the config options it may set
_PORTED = {"dense": (), "moe": ("moe", "mla"), "hybrid": ("ssm",),
           "ssm": ("rwkv",), "encdec": ("encdec",), "vlm": ("vision",)}


def _unsupported(cfg: ModelConfig) -> Optional[str]:
    if cfg.family not in _PORTED:
        return f"family {cfg.family!r}"
    for opt in ("mla", "moe", "ssm", "rwkv", "encdec", "vision"):
        if getattr(cfg, opt) is not None and opt not in _PORTED[cfg.family]:
            return f"option {opt!r}"
    return None


def _zeros_stacked(n: int, tree):
    """A per-layer cache tree -> fresh zeros of ``[n, ...]`` for each leaf
    (its own storage per layer, so a layer's in-place write stays in it)."""
    return {k: torch.zeros((n,) + tuple(v.shape), dtype=v.dtype,
                           device=v.device) for k, v in tree.items()}


class Model:
    def __init__(self, cfg: ModelConfig, device="cuda"):
        what = _unsupported(cfg)
        if what is not None:
            raise NotImplementedError(
                f"{cfg.name}: {what} is not ported; the port runs the "
                f"{', '.join(_PORTED)} families")
        self.cfg = cfg
        self.dtype = _dtype(cfg.dtype)
        self.v_pad = pad_vocab(cfg.vocab_size, 256)
        self.device = resolve_device(device)
        self._placer = None

    # =================================================================== init
    def init(self, seed: Union[int, torch.Generator], placer=None) -> Params:
        """Random params drawn from ``seed`` (an int, or a generator on the
        model's device). With a ``sharding.Placer`` the same stream is
        drawn, but each stacked layer is cut to this rank's share as soon
        as it is drawn, and the tree comes back as DTensors."""
        gen = seed
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self._placer = placer
        try:
            p = self._init_tree(gen)
        finally:
            self._placer = None
        return p if placer is None else placer.finish(p)

    def abstract_params(self) -> Params:
        """The params tree's shapes and dtypes as meta tensors, with no
        allocation (``jax.eval_shape(model.init, key)``): ``init`` run on
        fake tensors."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        model = Model(self.cfg, device="cpu")
        with FakeTensorMode():
            fake = model.init(0)
        return tree_from_items(
            (path, torch.empty(x.shape, dtype=x.dtype, device="meta"))
            for path, x in tree_items(fake))

    def abstract_cache(self, batch: int, seq: int,
                       dtype=torch.bfloat16) -> Params:
        """``init_cache``'s tree as meta tensors, with no allocation."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        model = Model(self.cfg, device="cpu")
        with FakeTensorMode():
            fake = model.init_cache(batch, seq, dtype)
        return tree_from_items(
            (path, torch.empty(x.shape, dtype=x.dtype, device="meta"))
            for path, x in tree_items(fake))

    @staticmethod
    def stacked_dims(path) -> int:
        """How many leading dims of the leaf at ``path`` stack layers."""
        path = tuple(path)
        if path[:2] == ("groups", "self"):
            return 2
        if path[:1] in (("layers",), ("dense_layers",), ("moe_layers",)) \
                or path[:2] in (("encoder", "layers"), ("groups", "cross")):
            return 1
        return 0

    def _init_tree(self, gen) -> Params:
        cfg = self.cfg
        d = cfg.d_model
        p = {
            "embed": {"w": embed_init(gen, (self.v_pad, d), self.dtype)},
            "final_norm": self._ones(),
            "lm_head": {"w": dense_init(gen, d, (d, self.v_pad), self.dtype)},
        }
        if cfg.family == "ssm":
            p["ln0_s"] = self._ones()
            p["ln0_b"] = self._zeros()
            # read by nothing; kept so that trees and checkpoints match
            p["final_norm_b"] = self._zeros()
            p["layers"] = self._init_stack(gen, cfg.n_layers,
                                           self._init_rwkv_block,
                                           ("layers",))
        elif cfg.family == "encdec":
            p["encoder"] = {
                "layers": self._init_stack(gen, cfg.encdec.n_enc_layers,
                                           self._init_dense_block,
                                           ("encoder", "layers")),
                "final_norm": self._ones(),
            }
            p["layers"] = self._init_stack(gen, cfg.n_layers,
                                           self._init_encdec_block,
                                           ("layers",))
        elif cfg.family == "vlm":
            v = cfg.vision
            g, per = self._groups()
            p["vis_proj"] = dense_init(gen, v.d_vision, (v.d_vision, d),
                                       self.dtype)
            p["groups"] = {
                "self": self._init_stack(gen, (g, per),
                                         self._init_dense_block,
                                         ("groups", "self")),
                "cross": self._init_stack(gen, g, self._init_cross_block,
                                          ("groups", "cross")),
            }
        elif cfg.family == "moe":
            nd = cfg.moe.first_dense_layers
            if nd:
                p["dense_layers"] = self._init_stack(
                    gen, nd, self._init_dense_block, ("dense_layers",))
            p["moe_layers"] = self._init_stack(gen, cfg.n_layers - nd,
                                               self._init_moe_block,
                                               ("moe_layers",))
            if cfg.mtp_depth:
                p["mtp"] = {
                    "proj": dense_init(gen, 2 * d, (2 * d, d), self.dtype),
                    "norm_h": self._ones(), "norm_e": self._ones(),
                    "block": self._init_dense_block(gen)}
        else:  # dense / hybrid
            p["layers"] = self._init_stack(gen, cfg.n_layers,
                                           self._init_block, ("layers",))
        return p

    def _ones(self):
        return torch.ones((self.cfg.d_model,), dtype=torch.float32,
                          device=self.device)

    def _zeros(self):
        return torch.zeros((self.cfg.d_model,), dtype=torch.float32,
                           device=self.device)

    def _groups(self) -> Tuple[int, int]:
        """vlm's (groups, self blocks a group)."""
        g = self.cfg.vision.n_cross_layers
        return g, self.cfg.n_layers // g

    def _init_stack(self, gen, n, init_one, path):
        """``n`` (an int, or vlm's ``(groups, per)``) layers drawn in order
        and stacked; with a placer, each layer is cut to this rank's share
        of the stack at ``path`` as it is drawn."""
        counts = (n,) if isinstance(n, int) else tuple(n)
        if self._placer is not None:
            return self._placer.stack(path, counts, lambda: init_one(gen))

        def build(c):
            if len(c) == 1:
                return _stack([init_one(gen) for _ in range(c[0])])
            return _stack([build(c[1:]) for _ in range(c[0])])

        return build(counts)

    def _init_attn(self, gen):
        """Self-attention's params: MLA's when ``cfg.mla`` is set."""
        cfg = self.cfg
        if cfg.mla is not None:
            return mla.init_mla(gen, cfg.d_model, cfg.n_heads, cfg.mla,
                                self.dtype)
        return attn.init_attention(gen, cfg.d_model, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.resolved_head_dim,
                                   self.dtype, cfg.qkv_bias)

    def _init_dense_block(self, gen):
        cfg = self.cfg
        return {"attn": self._init_attn(gen),
                "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act,
                                self.dtype),
                "ln1": self._ones(),
                "ln2": self._ones()}

    def _init_moe_block(self, gen):
        cfg = self.cfg
        return {"attn": self._init_attn(gen),
                "moe": moe.init_moe(gen, cfg.d_model, cfg.moe, self.dtype),
                "ln1": self._ones(),
                "ln2": self._ones()}

    def _init_block(self, gen):
        cfg = self.cfg
        p = self._init_dense_block(gen)
        if cfg.ssm is not None:  # hymba hybrid: parallel SSM branch
            p["ssm"] = mamba.init_ssm(gen, cfg.d_model, cfg.ssm, self.dtype)
            p["attn_out_norm"] = self._ones()
            p["ssm_out_norm"] = self._ones()
        return p

    def _init_rwkv_block(self, gen):
        cfg = self.cfg
        return {"tm": rwkv6.init_time_mix(gen, cfg.d_model, cfg.rwkv,
                                          self.dtype),
                "cm": rwkv6.init_channel_mix(gen, cfg.d_model, cfg.d_ff,
                                             self.dtype),
                "ln1_s": self._ones(), "ln1_b": self._zeros(),
                "ln2_s": self._ones(), "ln2_b": self._zeros()}

    def _init_xattn(self, gen):
        """Cross-attention's projections (no QKV bias)."""
        cfg = self.cfg
        return attn.init_attention(gen, cfg.d_model, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.resolved_head_dim,
                                   self.dtype)

    def _init_cross_block(self, gen):
        """vlm's gated cross block; its gates start at 0, as the
        reference's."""
        cfg = self.cfg
        gate = lambda: torch.zeros((), dtype=torch.float32,
                                   device=self.device)
        return {"xattn": self._init_xattn(gen),
                "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act,
                                self.dtype),
                "gate_attn": gate(), "gate_mlp": gate(),
                "ln1": self._ones(), "ln2": self._ones()}

    def _init_encdec_block(self, gen):
        return dict(self._init_dense_block(gen),
                    xattn=self._init_xattn(gen), lnx=self._ones())

    # ============================================================== forward
    def _window_flags(self) -> Optional[List[int]]:
        """Per-layer effective window (int32 max // 2 for global layers:
        effectively no window), or None without a sliding window."""
        cfg = self.cfg
        if cfg.window is None:
            return None
        wins = [cfg.window] * cfg.n_layers
        for g in cfg.global_layers:
            wins[g] = (2 ** 31 - 1) // 2
        return wins

    def _block_fwd(self, p, x, positions, window=None, chunk=512):
        """A pre-norm block (MLA or GQA attention, hymba's parallel SSM
        branch, then an MLP or a routed MoE) -> (x, aux): the MoE's aux
        term (an f32 scalar), 0.0 for a block without one."""
        cfg = self.cfg
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        if cfg.mla is not None:
            a = mla.apply_mla(p["attn"], h, n_heads=cfg.n_heads, m=cfg.mla,
                              theta=cfg.rope_theta, positions=positions,
                              chunk=chunk)
        else:
            a = attn.self_attention(p["attn"], h, cfg=cfg,
                                    positions=positions, causal=True,
                                    window=window, chunk=chunk)
        if cfg.ssm is not None:
            s = mamba.apply_ssm(p["ssm"], h, d_model=cfg.d_model,
                                ssm_cfg=cfg.ssm)
            x = x + 0.5 * (rms_norm(a, p["attn_out_norm"], cfg.norm_eps)
                           + rms_norm(s, p["ssm_out_norm"], cfg.norm_eps))
        else:
            x = x + a
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        if "moe" in p:
            out, aux = moe.apply_moe(p["moe"], h2, mo=cfg.moe, act=cfg.act)
            return constrain(x + out, ("batch", None, "act_d")), aux
        return constrain(x + apply_mlp(p["mlp"], h2, cfg.act),
                         ("batch", None, "act_d")), 0.0

    def _rwkv_block_fwd(self, p, x):
        cfg = self.cfg
        h = layer_norm(x, p["ln1_s"], p["ln1_b"], cfg.norm_eps)
        x = x + rwkv6.apply_time_mix(p["tm"], h, n_heads=cfg.n_heads,
                                     rwkv_cfg=cfg.rwkv)
        h = layer_norm(x, p["ln2_s"], p["ln2_b"], cfg.norm_eps)
        return x + rwkv6.apply_channel_mix(p["cm"], h)

    def _cross_block_fwd(self, p, x, memory):
        """vlm's gated cross block: ``tanh(gate)`` in the activations'
        dtype scales the cross-attention and the MLP."""
        cfg = self.cfg
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        g_a = torch.tanh(p["gate_attn"]).to(x.dtype)
        x = x + g_a * attn.cross_attention(p["xattn"], h, memory, cfg=cfg)
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        g_m = torch.tanh(p["gate_mlp"]).to(x.dtype)
        return x + g_m * apply_mlp(p["mlp"], h, cfg.act)

    def _encdec_block_fwd(self, p, x, memory, positions):
        cfg = self.cfg
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        x = x + attn.self_attention(p["attn"], h, cfg=cfg,
                                    positions=positions, causal=True,
                                    rope=False)
        h = rms_norm(x, p["lnx"], cfg.norm_eps)
        x = x + attn.cross_attention(p["xattn"], h, memory, cfg=cfg)
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + apply_mlp(p["mlp"], h, cfg.act)

    def _enc_block_fwd(self, p, x, positions):
        """An encoder block: bidirectional self-attention, no RoPE."""
        cfg = self.cfg
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        x = x + attn.self_attention(p["attn"], h, cfg=cfg,
                                    positions=positions, causal=False,
                                    rope=False)
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + apply_mlp(p["mlp"], h, cfg.act)

    @staticmethod
    def _gather_top(params):
        """``params`` with its unstacked leaves (embedding, head, norms,
        vlm's projection, the MTP head's projections) gathered over the
        batch axes; the stacks stay as they are (their blocks gather a
        layer at a time)."""
        if get_rules() is None:
            return params
        stacks = ("layers", "dense_layers", "moe_layers", "encoder",
                  "groups")
        return {k: v if k in stacks else gather_batch_axes(v)
                for k, v in params.items()}

    def _remat_mode(self) -> str:
        return self.cfg.remat if torch.is_grad_enabled() else "none"

    def _encode(self, params, frames) -> torch.Tensor:
        """The encoder over precomputed frame embeddings [B, S, d]: the
        frames cast to the model's dtype, plus the sinusoidal positions in
        that dtype, then the blocks and the encoder's final norm."""
        cfg = self.cfg
        b, s, d = frames.shape
        x = frames.to(self.dtype) + sinusoidal_pos(
            s, d, device=frames.device).to(self.dtype)
        positions = torch.arange(s, device=frames.device)
        body = _remat(self._enc_block_fwd, self._remat_mode())
        for p in unstack_layers(params["encoder"]["layers"],
                                cfg.encdec.n_enc_layers):
            x = body(p, x, positions)
        return rms_norm(x, params["encoder"]["final_norm"], cfg.norm_eps)

    def _backbone_encdec(self, params, x, memory, positions):
        """Decoder blocks over the embedded tokens (positions added)."""
        body = _remat(self._encdec_block_fwd, self._remat_mode())
        for p in unstack_layers(params["layers"], self.cfg.n_layers):
            x = body(p, x, memory, positions)
        return x

    def _backbone_vlm(self, params, x, vis, positions):
        """Each group's self blocks, then its cross block to ``vis``."""
        g, per = self._groups()
        remat = self._remat_mode()
        self_body = _remat(self._block_fwd, remat)
        cross_body = _remat(self._cross_block_fwd, remat)
        groups = params["groups"]
        for gs, gc in zip(unstack_layers(groups["self"], g),
                          unstack_layers(groups["cross"], g)):
            for p in unstack_layers(gs, per):
                x, _ = self_body(p, x, positions)
            x = cross_body(gc, x, vis)
        return x

    def _hidden(self, params, batch, x):
        """Embedded tokens [B, S, d] -> (final hidden states, aux: the sum
        of the MoE blocks' aux terms, 0.0 without any), for every family;
        encdec reads ``batch["frames"]``, vlm ``batch["patches"]``
        (projected by ``vis_proj`` in the model's dtype)."""
        cfg = self.cfg
        s = x.shape[1]
        positions = torch.arange(s, device=x.device)
        if cfg.family == "encdec":
            memory = self._encode(params, batch["frames"])
            x = x + sinusoidal_pos(s, cfg.d_model,
                                   device=x.device).to(self.dtype)
            return self._backbone_encdec(params, x, memory, positions), 0.0
        if cfg.family == "vlm":
            vis = batch["patches"].to(self.dtype) @ params["vis_proj"]
            return self._backbone_vlm(params, x, vis, positions), 0.0
        if cfg.family == "moe":
            return self._backbone_moe(params, x, positions)
        return self._backbone(params, x, positions), 0.0

    def _moe_layers(self, params, split=unstack_layers):
        """The moe family's blocks in order, the leading dense ones then the
        MoE ones, each stack taken apart by ``split`` (``unstack_layers``,
        or per-layer views for decode)."""
        cfg = self.cfg
        nd = cfg.moe.first_dense_layers
        dense = split(params["dense_layers"], nd) if nd else []
        return dense + split(params["moe_layers"], cfg.n_layers - nd)

    def _backbone_moe(self, params, x, positions):
        """The moe family's blocks, each under ``_remat(..., cfg.remat)``
        -> (hidden states, the MoE blocks' aux terms summed in order)."""
        body = _remat(self._block_fwd, self._remat_mode())
        aux = 0.0
        for p in self._moe_layers(params):
            x, a = body(p, x, positions)
            aux = aux + a
        return x, aux

    def _backbone(self, params, x, positions) -> torch.Tensor:
        """Token embeddings -> final hidden states (the dense, hybrid and
        ssm families). With grad mode on, each block runs under
        ``_remat(..., cfg.remat)``."""
        cfg = self.cfg
        layers = unstack_layers(params["layers"], cfg.n_layers)
        remat = self._remat_mode()
        if cfg.family == "ssm":
            x = layer_norm(x, params["ln0_s"], params["ln0_b"], cfg.norm_eps)
            body = _remat(self._rwkv_block_fwd, remat)
            for p in layers:
                x = body(p, x)
            return x
        body = _remat(self._block_fwd, remat)
        wins = self._window_flags()
        for i, p in enumerate(layers):
            x, _ = body(p, x, positions, None if wins is None else wins[i])
        return x

    # ================================================================= losses
    def loss_fn(self, params, batch) -> Tuple[torch.Tensor,
                                              Dict[str, torch.Tensor]]:
        """Mean next-token CE of ``batch`` ({"tokens", "labels"} [B, S],
        with ``"frames"`` for encdec and ``"patches"`` for vlm) -> ``(loss,
        metrics)``, the reference's loss: ``ce``, plus for the moe family
        ``aux_loss_weight * aux`` (the MoE blocks' aux terms summed) and,
        with an MTP head, ``0.3 * mtp`` (``_mtp_loss``); ``metrics`` holds
        ``"ce"`` and, where they enter, ``"aux"`` and ``"mtp"``. The
        embedding is the one-hot contraction (``layers.embed_onehot``), so
        the gradient is the same from run to run on the card. The ssm
        family's ``ln0`` is ``_backbone``'s; its ``final_norm_b`` is read
        by nothing, so autograd gives it no gradient (the trainers turn
        that into zeros, the reference's)."""
        cfg = self.cfg
        tokens, labels = batch["tokens"], batch["labels"]
        params = self._gather_top(params)
        x = constrain(embed_onehot(params["embed"]["w"], tokens),
                      ("batch", "seq", "embed"))
        x, aux = self._hidden(params, batch, x)
        x = constrain(x, ("batch", "seq", "embed"))
        h = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = constrain(h @ params["lm_head"]["w"],
                           ("batch", "seq", "vocab"))
        ce = cross_entropy(logits, labels, cfg.vocab_size)
        loss, metrics = ce, {"ce": ce}
        if cfg.moe is not None:
            loss = loss + cfg.moe.aux_loss_weight * aux
            metrics["aux"] = aux
        if cfg.mtp_depth and "mtp" in params:
            mtp = self._mtp_loss(params, h, tokens, labels)
            loss = loss + 0.3 * mtp
            metrics["mtp"] = mtp
        return loss, metrics

    def _mtp_loss(self, params, h, tokens, labels):
        """DeepSeek's MTP: ``[norm_h(h_t) ; norm_e(emb(token_{t+1}))]``
        through ``proj``, one dense block (MLA attention, outside
        ``_remat``, as the reference's) and the shared final norm and head;
        its ``logits[:, :-1]`` scored against ``labels[:, 2:]``, the
        reference's pairing. h: the final-normed hidden states [B, S, d]."""
        cfg = self.cfg
        mp = params["mtp"]
        emb_next = embed_onehot(params["embed"]["w"], tokens[:, 1:])
        h_in = torch.cat([rms_norm(h[:, :-1], mp["norm_h"], cfg.norm_eps),
                          rms_norm(emb_next, mp["norm_e"], cfg.norm_eps)],
                         dim=-1)
        positions = torch.arange(h_in.shape[1], device=h.device)
        x, _ = self._block_fwd(gather_batch_axes(mp["block"]),
                               h_in @ mp["proj"], positions)
        logits = rms_norm(x, params["final_norm"],
                          cfg.norm_eps) @ params["lm_head"]["w"]
        return cross_entropy(logits[:, :-1], labels[:, 2:], cfg.vocab_size)

    # ================================================================ caches
    def init_cache(self, batch: int, seq: int,
                   dtype=torch.bfloat16) -> Params:
        """Zeroed caches, ``[L, ...]`` for every leaf (vlm's self-attention
        ``[G, per, ...]``, its cross caches ``[G, ...]`` over
        ``n_patches``; MLA's latent ``c_kv`` and rope key ``k_rope`` for
        every layer, the leading dense ones too). ``dtype`` is the K and V
        caches' (the cross caches' and MLA's too); the recurrent states are
        f32 whatever it is, and so is hymba's conv history (the reference
        builds it with ``init_ssm_cache``'s default dtype)."""
        cfg = self.cfg
        L = cfg.n_layers
        if cfg.family == "ssm":
            return _zeros_stacked(L, rwkv6.init_rwkv_cache(
                batch, cfg.d_model, cfg.n_heads, cfg.rwkv, self.device))
        if cfg.mla is not None:
            return {"mla": _zeros_stacked(L, mla.init_mla_cache(
                batch, seq, cfg.mla, dtype, self.device))}
        head = (cfg.n_kv_heads, cfg.resolved_head_dim)
        zeros = lambda *lead: torch.zeros(lead + head, dtype=dtype,
                                          device=self.device)
        if cfg.family == "vlm":
            g, per = self._groups()
            n = cfg.vision.n_patches
            return {"k": zeros(g, per, batch, seq),
                    "v": zeros(g, per, batch, seq),
                    "ck": zeros(g, batch, n), "cv": zeros(g, batch, n)}
        cache = {"k": zeros(L, batch, seq), "v": zeros(L, batch, seq)}
        if cfg.family == "encdec":
            cache["ck"] = zeros(L, batch, seq)
            cache["cv"] = zeros(L, batch, seq)
        if cfg.family == "hybrid":
            cache["ssm"] = _zeros_stacked(L, mamba.init_ssm_cache(
                batch, cfg.d_model, cfg.ssm, device=self.device))
        return cache

    # ================================================================= decode
    def decode_step(self, params, cache, tokens, pos
                    ) -> Tuple[torch.Tensor, Params]:
        """One-token decode. tokens: [B] int; pos: int. Returns the logits
        [B, v_pad] and the cache (written in place). Under sharding rules
        every weight is gathered over the batch axes first."""
        cfg = self.cfg
        params = gather_batch_axes(params)
        x = embed_lookup(params["embed"]["w"], tokens)       # [B, d]
        if cfg.family == "ssm":
            x = layer_norm(x, params["ln0_s"], params["ln0_b"], cfg.norm_eps)
            x, cache = self._decode_rwkv(params, cache, x)
        elif cfg.mla is not None:
            x, cache = self._decode_mla(params, cache, x, pos)
        elif cfg.family == "moe":
            x, cache = self._decode_moe_gqa(params, cache, x, pos)
        elif cfg.family == "vlm":
            x, cache = self._decode_vlm(params, cache, x, pos)
        elif cfg.family == "encdec":
            x = x + sinusoidal_pos(1, cfg.d_model, offset=pos,
                                   device=x.device)[0].to(x.dtype)
            x, cache = self._decode_encdec(params, cache, x, pos)
        else:
            x, cache = self._decode_dense(params, cache, x, pos)
        h = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = constrain(h @ params["lm_head"]["w"], ("batch", "vocab"))
        return logits, cache

    def _decode_block(self, p, x, kc, vc, pos, window, ssm_cache=None):
        cfg = self.cfg
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        a, kc, vc = attn.decode_self_attention(p["attn"], h, kc, vc, pos,
                                               cfg=cfg, window=window)
        if ssm_cache is not None:
            s, _ = mamba.decode_ssm(p["ssm"], h, ssm_cache,
                                    d_model=cfg.d_model, ssm_cfg=cfg.ssm)
            x = x + 0.5 * (rms_norm(a, p["attn_out_norm"], cfg.norm_eps)
                           + rms_norm(s, p["ssm_out_norm"], cfg.norm_eps))
        else:
            x = x + a
        return self._decode_ffn(p, x), kc, vc

    def _decode_ffn(self, p, x):
        """A decode block's second half: ``x`` plus its MLP or, in a MoE
        block, its routed MoE over the B tokens (T = B, as the reference
        routes ``h2[:, None, :]``)."""
        cfg = self.cfg
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        if "moe" in p:
            out, _ = moe.apply_moe(p["moe"], h2[:, None, :], mo=cfg.moe,
                                   act=cfg.act)
            return x + out[:, 0]
        return x + apply_mlp(p["mlp"], h2, cfg.act)

    def _decode_layers(self, params):
        """The moe family's blocks in order as per-layer views."""
        return self._moe_layers(params, lambda tree, n: [
            layer_params(tree, i) for i in range(n)])

    def _decode_moe_gqa(self, params, cache, x, pos):
        """kimi's GQA blocks, dense then MoE, each writing its layer of
        ``k`` / ``v`` in place."""
        for i, p in enumerate(self._decode_layers(params)):
            x, _, _ = self._decode_block(p, x, cache["k"][i],
                                         cache["v"][i], pos, None)
        return x, cache

    def _decode_mla(self, params, cache, x, pos):
        """deepseek's MLA blocks, dense then MoE: the absorbed decode
        against each layer's latent cache (written in place), then the MLP
        or the MoE."""
        cfg = self.cfg
        mc = cache["mla"]
        for i, p in enumerate(self._decode_layers(params)):
            h = rms_norm(x, p["ln1"], cfg.norm_eps)
            a, _ = mla.decode_mla(p["attn"], h, layer_params(mc, i), pos,
                                  n_heads=cfg.n_heads, m=cfg.mla,
                                  theta=cfg.rope_theta)
            x = self._decode_ffn(p, x + a)
        return x, cache

    def _decode_dense(self, params, cache, x, pos):
        """Dense and hybrid layers; every cache leaf's ``[i]`` is a view, so
        each block writes the stacked caches in place."""
        wins = self._window_flags()
        ssm = cache.get("ssm")
        for i in range(self.cfg.n_layers):
            x, _, _ = self._decode_block(
                layer_params(params["layers"], i), x, cache["k"][i],
                cache["v"][i], pos, None if wins is None else wins[i],
                None if ssm is None else layer_params(ssm, i))
        return x, cache

    def _decode_rwkv(self, params, cache, x):
        cfg = self.cfg
        for i in range(cfg.n_layers):
            p, c = layer_params(params["layers"], i), layer_params(cache, i)
            h = layer_norm(x, p["ln1_s"], p["ln1_b"], cfg.norm_eps)
            tm_out, _ = rwkv6.decode_time_mix(p["tm"], h, c,
                                              n_heads=cfg.n_heads,
                                              rwkv_cfg=cfg.rwkv)
            x = x + tm_out
            h = layer_norm(x, p["ln2_s"], p["ln2_b"], cfg.norm_eps)
            cm_out, _ = rwkv6.decode_channel_mix(p["cm"], h, c)
            x = x + cm_out
        return x, cache

    def _decode_cross(self, p, x, ck, cv):
        """vlm's gated cross block on one token against its cross cache."""
        cfg = self.cfg
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        a = attn.decode_cross_attention(p["xattn"], h, ck, cv, cfg=cfg)
        x = x + torch.tanh(p["gate_attn"]).to(x.dtype) * a
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + torch.tanh(p["gate_mlp"]).to(x.dtype) * apply_mlp(
            p["mlp"], h, cfg.act)

    def _decode_vlm(self, params, cache, x, pos):
        """Each group's self blocks (their K / V written in place), then
        its cross block against ``ck`` / ``cv`` (read only)."""
        g, per = self._groups()
        groups = params["groups"]
        for gi in range(g):
            gs = layer_params(groups["self"], gi)
            for j in range(per):
                x, _, _ = self._decode_block(
                    layer_params(gs, j), x, cache["k"][gi, j],
                    cache["v"][gi, j], pos, None)
            x = self._decode_cross(layer_params(groups["cross"], gi), x,
                                   cache["ck"][gi], cache["cv"][gi])
        return x, cache

    def _decode_encdec(self, params, cache, x, pos):
        """Decoder blocks: self-attention without RoPE (K / V written in
        place), cross-attention against ``ck`` / ``cv`` (read only)."""
        cfg = self.cfg
        for i in range(cfg.n_layers):
            p = layer_params(params["layers"], i)
            h = rms_norm(x, p["ln1"], cfg.norm_eps)
            a, _, _ = attn.decode_self_attention(
                p["attn"], h, cache["k"][i], cache["v"][i], pos, cfg=cfg,
                rope=False)
            x = x + a
            h = rms_norm(x, p["lnx"], cfg.norm_eps)
            x = x + attn.decode_cross_attention(
                p["xattn"], h, cache["ck"][i], cache["cv"][i], cfg=cfg)
            h = rms_norm(x, p["ln2"], cfg.norm_eps)
            x = x + apply_mlp(p["mlp"], h, cfg.act)
        return x, cache

    # ================================================================ prefill
    def prefill(self, params, batch) -> Tuple[torch.Tensor, None]:
        """Forward over the prompt ``batch["tokens"]`` [B, S], returning the
        last-token logits [B, v_pad] and no cache, as the reference's
        prefill does (encdec also reads ``batch["frames"]``, vlm
        ``batch["patches"]``). The recurrent families need S to be a
        multiple of their GLA chunk (the reference asserts it; nothing is
        padded)."""
        cfg = self.cfg
        params = self._gather_top(params)
        x = constrain(embed_lookup(params["embed"]["w"], batch["tokens"]),
                      ("batch", "seq", "embed"))
        x, _ = self._hidden(params, batch, x)
        h = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return h[:, -1, :] @ params["lm_head"]["w"], None
