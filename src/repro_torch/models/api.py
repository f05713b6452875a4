"""Model API of the port (the basecaller family and the dense LM):
parameter init and the serving engine, on the device a caller names.

Entry points run on CUDA unless the caller asks for the CPU
(``device="cpu"``); without a card and without that request they
raise, never carrying on quietly on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.quant.policy import tree_map


def resolve_device(device=None) -> torch.device:
    """``None`` -> CUDA. Raises when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: pass device='cpu' (serve.py: "
            "--device cpu) to run on the CPU")
    return dev


def init_params(gen, cfg: ModelConfig, *, device=None):
    """Parameters of ``cfg``.

    Basecaller: fp32 CPU parameters drawn from ``gen`` (a CPU
    ``torch.Generator``). Dense LM: the layer-stacked tree in
    ``cfg.dtype``, drawn on the device that draws it, never on the host
    first: ``gen`` is a seed (drawn on ``device``, CUDA by default,
    through a ``torch.Generator`` there) or a ``torch.Generator`` (drawn
    on its device)."""
    if cfg.family == "basecaller":
        from repro_torch.models.basecaller import model as bc
        return bc.init_params(gen, cfg)
    from repro_torch.models.lm import transformer as tfm
    if not tfm.supports_slot_serving(cfg):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported")
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=resolve_device(device)).manual_seed(
            int(gen))
    return tfm.init_decoder(gen, cfg)


def make_serving_engine(params, cfg: ModelConfig, *, device=None, **kw):
    """Continuous-batching engine over this model on ``device``
    (default CUDA): the params move there, and the runner registry
    builds the backend (``TokenRunner`` for token LMs,
    ``BasecallerRunner`` for basecallers). Extra ``**kw`` reach the
    engine and runner: ``n_slots``; for token LMs ``cache_len``,
    ``prefill_chunk``, ``block_len``, ``n_blocks``, ``cache_dtype``,
    ``quant_policy``, ``attn_backend``; for basecallers
    ``chunk_samples``, ``beam``."""
    from repro_torch.serving.engine import ServingEngine
    dev = resolve_device(device)
    params = tree_map(lambda t: t.to(dev), params)
    return ServingEngine(params, cfg, device=dev, **kw)
