"""Model API of the port (basecaller family): parameter init and the
serving engine, on the device a caller names.

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


def init_params(gen: torch.Generator, cfg: ModelConfig):
    """fp32 CPU parameters of a basecaller config, drawn from ``gen``."""
    if cfg.family != "basecaller":
        raise NotImplementedError(
            f"{cfg.name}: only the basecaller family is ported")
    from repro_torch.models.basecaller import model as bc
    return bc.init_params(gen, cfg)


def make_serving_engine(params, cfg: ModelConfig, *, device=None, **kw):
    """Continuous-batching engine over this model on ``device``
    (default CUDA): the params move there, and the runner registry
    builds the backend (``BasecallerRunner``). Extra ``**kw`` reach the
    engine and runner (``n_slots``, ``chunk_samples``, ``beam``, ...)."""
    from repro_torch.serving.engine import ServingEngine
    dev = resolve_device(device)
    params = tree_map(lambda t: t.to(dev), params)
    return ServingEngine(params, cfg, device=dev, **kw)
