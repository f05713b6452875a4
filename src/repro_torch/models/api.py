"""Model API of the port (the basecaller family and the LM families
ported so far: ``dense`` and ``moe``, GQA or MLA, through the serving
engine; ``dense`` and ``ssm`` through the static path): parameter init,
the serving engine, the whole-prompt prefill and lockstep decode steps
and smoke batches, on the device a caller names.

Entry points run on CUDA unless the caller asks for the CPU
(``device="cpu"``); without a card and without that request they
raise, never carrying on quietly on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.quant.policy import tree_map
from repro_torch.device import resolve_device


def init_params(gen, cfg: ModelConfig, *, device=None, wbits: int = 0):
    """Parameters of ``cfg``.

    Basecaller: fp32 CPU parameters drawn from ``gen`` (a CPU
    ``torch.Generator``). LM: the layer-stacked tree in ``cfg.dtype``,
    drawn on the device that draws it, never on the host first: ``gen``
    is a seed (drawn on ``device``, CUDA by default, through a
    ``torch.Generator`` there) or a ``torch.Generator`` (drawn on its
    device). ``wbits`` 8 or 4 packs the weights as they are drawn, leaf
    by leaf and expert stacks a few experts at a time, so the float tree
    never exists whole on the device; the result equals
    ``quantize_tree(init_params(...), QuantPolicy(wbits, 0))``."""
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
    return tfm.init_decoder(gen, cfg, pack=pack)


def make_serving_engine(params, cfg: ModelConfig, *, device=None, **kw):
    """Continuous-batching engine over this model on ``device``
    (default CUDA): the params move there, and the runner registry
    builds the backend (``TokenRunner`` for token LMs,
    ``BasecallerRunner`` for basecallers). Extra ``**kw`` reach the
    engine and runner: ``n_slots``; for token LMs ``cache_len``,
    ``prefill_chunk``, ``block_len``, ``n_blocks``, ``cache_dtype``,
    ``quant_policy``, ``attn_backend``; for basecallers
    ``chunk_samples``, ``beam``, ``qos`` (``"accuracy"``: each window
    forwarded once, when covered; ``"latency"``: live windows
    re-forwarded as frames become stable) and ``read_until`` (a
    :class:`repro_torch.serving.stream.ReadUntil` whose classifier moves
    to ``device`` and ejects off-target reads)."""
    from repro_torch.serving.engine import ServingEngine
    if cfg.family == "ssm":
        raise NotImplementedError(
            f"{cfg.name}: the slot (continuous-batching) path of the 'ssm' "
            f"family is not ported; serve it through the static path "
            f"(launch/serve.py --static)")
    dev = resolve_device(device)
    params = tree_map(lambda t: t.to(dev), params)
    return ServingEngine(params, cfg, device=dev, **kw)


# ---------------------------------------------------------------------------
# The static path's steps and smoke batches


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, batch) -> (last logits (B, 1, V), caches)``
    over ``batch["tokens"]`` (B, S), caches of S positions."""
    from repro_torch.models.lm import transformer as tfm

    def prefill_step(params, batch):
        return tfm.prefill(params, batch["tokens"], cfg)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``decode_step(params, caches, tokens (B, 1), t) -> (logits,
    caches)``, every row at position ``t``; the caches update in place."""
    from repro_torch.models.lm import transformer as tfm

    def decode_step(params, caches, tokens, t):
        return tfm.decode_step(params, caches, tokens, t, cfg)
    return decode_step


def make_smoke_batch(gen, cfg: ModelConfig, batch: int = 2,
                     seq: int = 64, *, device=None):
    """A random token-LM batch on ``device`` (CUDA by default) from
    ``gen`` (a seed or a ``torch.Generator`` on that device): ``tokens``
    and ``labels`` (B, seq) int32 in [0, vocab)."""
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=resolve_device(device)).manual_seed(
            int(gen))
    return {name: torch.randint(0, cfg.vocab_size, (batch, seq),
                                generator=gen, device=gen.device,
                                dtype=torch.int32)
            for name in ("tokens", "labels")}
