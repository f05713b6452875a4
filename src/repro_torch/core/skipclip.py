"""SkipClip: gradual skip-connection removal under knowledge distillation.

The student's skip branches are gated by per-block scalars in [0, 1]
(see ``models.basecaller.blocks``); the schedule zeroes one gate every
``stride`` epochs, starting from the input side, while a frozen teacher
(Bonito, eval mode) distills into the student. Gate == 0 is
algebraically the skip-free topology, so after the last removal the
skip branches can be stripped from the param tree (``strip_skip_params``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.distill import kd_loss, skipclip_loss
from repro_torch.models.basecaller import model as bc
from repro_torch.models.basecaller.ctc import ctc_loss


@dataclasses.dataclass(frozen=True)
class SkipClipConfig:
    stride: int = 1         # epochs between removals (paper sweeps 1,2,3)
    alpha: float = 0.9      # student-loss weight   (paper S2)
    tau: float = 2.0        # KD temperature        (paper S2)


def gates_for_epoch(n_skips: int, epoch: int, stride: int, *,
                    device=None) -> torch.Tensor:
    """(n_skips,) fp32 gates; removal starts from the input side. Epoch
    0 keeps all skips; at the start of epoch e >= 1, ceil(e / stride)
    skips are removed, at most n_skips."""
    removed = 0 if epoch <= 0 else min(n_skips, -(-epoch // stride))
    return (torch.arange(n_skips, device=device) >= removed).float()


def make_skipclip_loss(student_cfg: ModelConfig, teacher_cfg: ModelConfig,
                       sc: SkipClipConfig) -> Callable:
    """Returns loss(student_params, student_state, teacher_params,
    teacher_state, batch, gates) -> (loss, (metrics, new_state)). The
    teacher runs in eval mode and without autograd."""
    def loss_fn(params, state, t_params, t_state, batch, gates):
        s_logp, new_state = bc.forward(params, state, batch["signal"],
                                       student_cfg, train=True,
                                       skip_gates=gates)
        with torch.no_grad():
            t_logp, _ = bc.forward(t_params, t_state, batch["signal"],
                                   teacher_cfg, train=False)
        l_s = ctc_loss(s_logp, batch["labels"], batch["label_lengths"])
        # frame-level KD needs one time axis: both families downsample
        # by the stem stride (3)
        l_d = kd_loss(s_logp, t_logp, tau=sc.tau)
        loss = skipclip_loss(l_s, l_d, alpha=sc.alpha)
        return loss, ({"ctc": l_s, "kd": l_d, "loss": loss}, new_state)
    return loss_fn


def strip_skip_params(params: Dict) -> Dict:
    """Remove skip-branch params entirely (post-removal model export)."""
    def walk(d):
        if isinstance(d, dict):
            return {k: walk(v) for k, v in d.items()
                    if k not in ("skip_pw", "skip_bn")}
        return d
    return walk(params)
