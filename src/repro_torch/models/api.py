"""Model API of the port (the basecaller family and every LM family of
the reference: ``dense``, ``moe`` (GQA or MLA, with the MTP head),
``ssm``, ``hybrid``, ``vlm`` (patch embeddings prepended) and
``audio`` (Whisper's encoder-decoder) in training; all but ``vlm``
through the serving engine, as the reference; all of them through
the static path): parameter init, the loss and train step, the serving
engine, the whole-prompt prefill and lockstep decode steps and smoke
batches, on the device a caller names; parameter counts from shapes
alone; the dry run's batch shapes (:func:`batch_struct`,
:func:`batch_specs`).

Entry points run on CUDA unless the caller asks for the CPU
(``device="cpu"``); without a card and without that request they
raise, never carrying on quietly on the CPU.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.quant.policy import (tree_leaves, tree_map,
                                           tree_unflatten)
from repro_torch.device import resolve_device
from repro_torch.training.optimizer import (AdamWConfig, OptState,
                                            adamw_update)

MICRO_TOKENS = 65536       # grad-accum target: tokens per microbatch


class TrainCarry(NamedTuple):
    params: Any
    opt_state: OptState
    model_state: Any        # e.g. BatchNorm running stats (basecaller)


def init_params(gen, cfg: ModelConfig, *, device=None, wbits: int = 0,
                dtype=None):
    """Parameters of ``cfg``.

    Basecaller: fp32 CPU parameters drawn from ``gen`` (a CPU
    ``torch.Generator``). LM: the layer-stacked tree in ``dtype``
    (default ``cfg.dtype``, what serving holds; training passes fp32
    for master leaves), drawn on the device that draws it, never on the
    host first: ``gen``
    is a seed (drawn on ``device``, CUDA by default, through a
    ``torch.Generator`` there) or a ``torch.Generator`` (drawn on its
    device). ``wbits`` 8 or 4 packs the weights as they are drawn, leaf
    by leaf and expert stacks a few experts at a time, so the float tree
    never exists whole on the device; the result equals
    ``quantize_tree(init_params(...), QuantPolicy(wbits, 0))``. The
    audio family's encoder is drawn last, under ``encoder``."""
    if cfg.family == "basecaller":
        from repro_torch.models.basecaller import model as bc
        return bc.init_params(gen, cfg)
    from repro_torch.models.lm import transformer as tfm
    tfm.layer_plan(cfg)          # raises for a family that is not ported
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=resolve_device(device)).manual_seed(
            int(gen))
    pack = None
    if wbits:
        from repro_torch.config import QuantPolicy
        from repro_torch.core.quant.policy import Packer
        pack = Packer(QuantPolicy(weight_bits=wbits, act_bits=0))
    params = tfm.init_decoder(gen, cfg, pack=pack, dtype=dtype)
    if cfg.family == "audio":
        from repro_torch.models.lm import encdec
        params["encoder"] = encdec.init_encoder(
            gen, cfg, dtype=getattr(torch, cfg.dtype) if dtype is None
            else dtype, pack=pack)
    return params


def init_model_state(cfg: ModelConfig):
    """Non-parameter model state: the basecaller's BatchNorm running
    stats (fp32 CPU tensors), ``{}`` for the LMs."""
    if cfg.family == "basecaller":
        from repro_torch.models.basecaller import model as bc
        return bc.init_state(cfg)
    return {}


def count_params_analytic(cfg: ModelConfig) -> int:
    """Parameter count of ``cfg`` from shapes alone: the init runs under
    ``FakeTensorMode``, so no storage is taken at any width (the
    truncated-normal helpers leave a fake tensor undrawn)."""
    import math

    from repro_torch.compat import FakeTensorMode
    with FakeTensorMode():
        params = init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    return sum(math.prod(leaf.shape) for leaf in tree_leaves(params))


def active_params(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: shared + top-k routed only)."""
    total = count_params_analytic(cfg)
    if cfg.family != "moe" or not cfg.n_experts:
        return total
    ff = cfg.moe_d_ff or cfg.d_ff
    n_moe_layers = cfg.n_layers - cfg.n_dense_layers
    routed = n_moe_layers * cfg.n_experts * 3 * cfg.d_model * ff
    active_routed = routed * cfg.experts_per_tok // cfg.n_experts
    return total - routed + active_routed


# ---------------------------------------------------------------------------
# Loss and train step


def make_loss_fn(cfg: ModelConfig) -> Callable:
    """``loss(params, model_state, batch) -> (loss, (metrics,
    new_state))``.

    Basecaller: the CTC loss (``model.loss_fn``). LM: the mean
    cross-entropy of ``batch["labels"]`` over the training forward of
    ``batch["tokens"]``, plus 0.01 x the MoE aux loss when
    ``cfg.n_experts`` and 0.3 x the MTP loss when ``cfg.mtp_depth``;
    metrics ``ce`` (and ``moe_aux``, ``mtp``). A vlm batch's
    ``patch_embeds`` are prepended and their positions cut off the
    hidden states before the unembedding; an audio batch's ``frames``
    go through the training encoder first. Over a tensor-parallel model
    group the logits are this rank's vocabulary columns and
    ``cross_entropy`` reduces its terms over the group, so both sums
    come out whole on every rank."""
    if cfg.family == "basecaller":
        from repro_torch.models.basecaller import model as bc

        def bc_loss(params, model_state, batch):
            return bc.loss_fn(params, model_state, batch, cfg)
        return bc_loss
    from repro_torch.models.lm import transformer as tfm
    from repro_torch.models.lm.common import cross_entropy
    tfm.layer_plan(cfg)          # raises for a family that is not ported

    def lm_loss(params, model_state, batch):
        kw = frontend_inputs(params, batch, cfg, train=True)
        h, aux = tfm.forward(params, batch["tokens"], cfg, train=True, **kw)
        if cfg.family == "vlm":
            h = h[:, batch["patch_embeds"].shape[1]:]
        lsum, wsum = cross_entropy(tfm.unembed(params, h, cfg),
                                   batch["labels"], vocab_size=cfg.vocab_size)
        loss = lsum / wsum.clamp_min(1.0)
        metrics = {"ce": loss}
        if cfg.n_experts:
            loss = loss + 0.01 * aux
            metrics["moe_aux"] = aux
        if cfg.mtp_depth:
            loss_mtp = _mtp_loss(params, h, batch, cfg)
            loss = loss + 0.3 * loss_mtp
            metrics["mtp"] = loss_mtp
        return loss, (metrics, model_state)
    return lm_loss


def frontend_inputs(params, batch: Dict, cfg: ModelConfig, *,
                    train: bool = False) -> Dict:
    """The frontend keywords of ``transformer.forward``/``prefill`` for
    ``batch``: a vlm batch's ``patch_embeds``, an audio batch's
    ``frames`` through the encoder (``train``: its differentiable
    attention) as ``enc_out``; none for the token families."""
    if cfg.family == "vlm":
        return {"patch_embeds": batch["patch_embeds"]}
    if cfg.family == "audio":
        from repro_torch.models.lm import encdec
        return {"enc_out": encdec.encode(params["encoder"], batch["frames"],
                                         cfg, train=train)}
    return {}


def _mtp_loss(params, h: torch.Tensor, batch: Dict, cfg: ModelConfig
              ) -> torch.Tensor:
    """DeepSeek-V3's multi-token prediction head (depth 1): position t
    predicts label t + 1 from the normed hidden state at t and the
    embedding of token t + 1, through one more block."""
    from repro_torch.models.lm import transformer as tfm
    from repro_torch.models.lm.common import cross_entropy, dense, rmsnorm
    mtp = params["mtp"]
    tokens, labels = batch["tokens"], batch["labels"]
    emb_next = tfm.embed_tokens(params, tokens[:, 1:], cfg)
    hcat = torch.cat([rmsnorm(mtp["norm"], h[:, :-1], cfg.norm_eps),
                      emb_next], dim=-1)
    x = dense(mtp["proj"], hcat, cfg=cfg, tag="mtp/proj")
    B, S1, _ = x.shape
    positions = torch.arange(S1, dtype=torch.int32,
                             device=x.device)[None, :].expand(B, S1)
    x, _, _ = tfm.block_forward(mtp["block"], x, positions, cfg,
                                "mla_dense" if cfg.mla else "dense",
                                train=True)
    lsum, wsum = cross_entropy(tfm.unembed(params, x, cfg), labels[:, 1:],
                               vocab_size=cfg.vocab_size)
    return lsum / wsum.clamp_min(1.0)


def n_microbatches(cfg: ModelConfig, batch: int, seq: int,
                   dp: int = 1) -> int:
    """Grad-accumulation factor: ~MICRO_TOKENS tokens per microbatch, but
    never slicing the batch below one example per data-parallel shard."""
    n = max(1, (batch * seq) // MICRO_TOKENS)
    n = min(n, max(batch // max(dp, 1), 1))
    while batch % n:
        n -= 1
    return n


def value_and_grad(loss_fn: Callable, params, *args):
    """``((loss, aux), grads)`` of ``loss_fn(params, *args) -> (loss,
    aux)`` with respect to every leaf of ``params`` (grads in the
    params' structure; zeros for a leaf the loss does not reach), by
    ``torch.autograd.grad``. ``aux`` is a tuple of trees (metrics, new
    model state) and comes back detached: the train-mode BatchNorm
    state carries the batch statistics' graph, which would otherwise
    grow across steps."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    with torch.enable_grad():
        loss, aux = loss_fn(tree_unflatten(params, leaves), *args)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    aux = tuple(tree_map(torch.Tensor.detach, a) for a in aux)
    return (loss.detach(), aux), tree_unflatten(params, list(grads))


def microbatch_grads(loss_fn: Callable, params, mstate, batch: Dict,
                     n_micro: int):
    """``(grads, loss, new model state)`` over ``batch`` split into
    ``n_micro`` microbatches along its first axis: the model state
    threads through them, their fp32 gradients and losses averaged."""
    grads, lsum = None, None
    for i in range(n_micro):
        mb = {k: x.reshape((n_micro, x.shape[0] // n_micro)
                           + x.shape[1:])[i] for k, x in batch.items()}
        (l, (_, mstate)), g = value_and_grad(loss_fn, params, mstate, mb)
        g = tree_map(lambda t: t.float(), g)
        grads = g if grads is None else tree_map(torch.add, grads, g)
        lsum = l if lsum is None else lsum + l
    if n_micro > 1:
        grads = tree_map(lambda g: g / n_micro, grads)
        lsum = lsum / n_micro
    return grads, lsum, mstate


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    n_micro: int = 1) -> Callable:
    """``train_step(carry, batch) -> (carry, metrics)``: the averaged
    gradients of ``n_micro`` microbatches (:func:`microbatch_grads`),
    one AdamW update. Metrics (``loss``, ``grad_norm``, ``lr``) are 0-d
    tensors on the params' device: nothing is read back."""
    loss_fn = make_loss_fn(cfg)

    def train_step(carry: TrainCarry, batch: Dict) -> Tuple[TrainCarry, Dict]:
        params, opt_state, mstate = carry
        grads, loss, mstate = microbatch_grads(loss_fn, params, mstate,
                                               batch, n_micro)
        new_params, new_opt, om = adamw_update(params, grads, opt_state,
                                               opt_cfg)
        return TrainCarry(new_params, new_opt, mstate), {"loss": loss, **om}

    return train_step


def make_serving_engine(params, cfg: ModelConfig, *, device=None, **kw):
    """Continuous-batching engine over this model on ``device``
    (default CUDA): the params move there, and the runner registry
    builds the backend (``TokenRunner`` for token LMs,
    ``EncoderPrefixRunner`` for the audio family, ``BasecallerRunner``
    for basecallers; the vlm family has none and raises). Extra ``**kw`` reach the
    engine and runner: ``n_slots``; for token LMs ``cache_len``,
    ``prefill_chunk``, ``block_len``, ``n_blocks``, ``cache_dtype``,
    ``quant_policy``, ``attn_backend``; for basecallers
    ``chunk_samples``, ``beam``, ``qos`` (``"accuracy"``: each window
    forwarded once, when covered; ``"latency"``: live windows
    re-forwarded as frames become stable) and ``read_until`` (a
    :class:`repro_torch.serving.stream.ReadUntil` whose classifier moves
    to ``device`` and ejects off-target reads); for every runner
    ``graphs`` (default True: on a card each tick plan is a CUDA graph
    captured at warmup; False keeps the plans eager)."""
    from repro_torch.serving.engine import ServingEngine
    dev = resolve_device(device)
    params = tree_map(lambda t: t.to(dev), params)
    return ServingEngine(params, cfg, device=dev, **kw)


# ---------------------------------------------------------------------------
# Batch shapes of the dry run


def batch_struct(cfg: ModelConfig, shape, *, device="meta") -> Dict:
    """The batch of one ``ShapeConfig`` step as empty tensors on
    ``device`` (default ``meta``: shapes and dtypes, no storage; the dry
    run makes them under ``FakeTensorMode`` on the CPU): the reference's
    ``batch_struct``, leaf for leaf. Decode takes one token a row and
    its position ``t`` (0-d)."""
    B, S = shape.global_batch, shape.seq_len
    i32, f32 = torch.int32, torch.float32

    def sd(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=device)
    if cfg.family == "basecaller":
        return {"signal": sd((B, S, 1), f32),
                "labels": sd((B, S // 8), i32),
                "label_lengths": sd((B,), i32)}
    if shape.kind == "decode":
        return {"tokens": sd((B, 1), i32), "t": sd((), i32)}
    tok = {"tokens": sd((B, S), i32)}
    if cfg.family == "vlm":
        Pt = cfg.frontend_tokens
        tok = {"tokens": sd((B, S - Pt), i32),
               "patch_embeds": sd((B, Pt, cfg.d_model), f32)}
    if cfg.family == "audio":
        tok["frames"] = sd((B, cfg.frontend_tokens, cfg.d_model), f32)
    if shape.kind == "train":
        lab = (B, S - cfg.frontend_tokens) if cfg.family == "vlm" else (B, S)
        tok["labels"] = sd(lab, i32)
    return tok


def batch_specs(cfg: ModelConfig, shape, mesh_axes: Tuple[str, ...]
                ) -> Dict:
    """Partition specs matching :func:`batch_struct`: the batch dim over
    every non-'model' axis (filtered against the mesh's sizes where the
    shardings are made), the rest replicated; a 0-d leaf replicated."""
    from repro_torch.parallel.sharding import Spec
    dp = tuple(a for a in mesh_axes if a != "model")

    def spec_of(leaf):
        if not leaf.shape:
            return Spec()
        return Spec(dp if leaf.shape[0] > 1 else None,
                    *([None] * (leaf.ndim - 1)))
    return {k: spec_of(v) for k, v in batch_struct(cfg, shape).items()}


# ---------------------------------------------------------------------------
# The static path's steps and smoke batches


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, batch) -> (last logits (B, 1, V), caches)``
    over ``batch["tokens"]`` (B, S) (after a vlm batch's patches; an
    audio batch's frames encoded first), caches of the sequence's
    positions."""
    from repro_torch.models.lm import transformer as tfm

    def prefill_step(params, batch):
        return tfm.prefill(params, batch["tokens"], cfg,
                           **frontend_inputs(params, batch, cfg))
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``decode_step(params, caches, tokens (B, 1), t) -> (logits,
    caches)``, every row at position ``t``: a 0-d int32 tensor (the
    reference's traced scalar) or an int, made such a tensor on the
    tokens' device once (``transformer.decode_step``); the caches update
    in place."""
    from repro_torch.models.lm import transformer as tfm

    def decode_step(params, caches, tokens, t):
        return tfm.decode_step(params, caches, tokens, t, cfg)
    return decode_step


def make_smoke_batch(gen, cfg: ModelConfig, batch: int = 2,
                     seq: int = 64, *, device=None):
    """A random batch on ``device`` (CUDA by default) from ``gen`` (a
    seed or a ``torch.Generator`` on that device). Basecaller:
    ``signal`` (B, seq, 1) fp32 normal, ``labels`` (B, seq // 8) int32 in
    [1, n_bases), ``label_lengths`` (B,) = seq // 8. Token LM:
    ``tokens`` and ``labels`` (B, seq) int32 in [0, vocab); a vlm batch's
    lose their first ``frontend_tokens`` columns to ``patch_embeds`` (B,
    frontend_tokens, d) fp32 normal; an audio batch adds ``frames`` (B,
    frontend_tokens, d) fp32 normal."""
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=resolve_device(device)).manual_seed(
            int(gen))
    if cfg.family == "basecaller":
        L = seq // 8
        return {"signal": torch.randn((batch, seq, 1), generator=gen,
                                      device=gen.device),
                "labels": torch.randint(1, cfg.n_bases, (batch, L),
                                        generator=gen, device=gen.device,
                                        dtype=torch.int32),
                "label_lengths": torch.full((batch,), L, dtype=torch.int32,
                                            device=gen.device)}
    out = {name: torch.randint(0, cfg.vocab_size, (batch, seq),
                               generator=gen, device=gen.device,
                               dtype=torch.int32)
           for name in ("tokens", "labels")}
    if cfg.family in ("vlm", "audio"):
        P = cfg.frontend_tokens
        emb = torch.randn((batch, P, cfg.d_model), generator=gen,
                          device=gen.device)
        if cfg.family == "vlm":
            out = {k: v[:, P:] for k, v in out.items()}
            out["patch_embeds"] = emb
        else:
            out["frames"] = emb
    return out
