"""Knowledge-distillation losses (paper: KL divergence with temperature).
Used by SkipClip (teacher = Bonito with skips, student = QABAS model).
"""
from __future__ import annotations

import torch


def kd_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
            tau: float = 2.0) -> torch.Tensor:
    """KL(teacher || student) over the last axis, with temperature
    softening, scaled by tau^2 (Hinton's correction, so the gradient's
    magnitude does not depend on tau)."""
    t = torch.log_softmax(teacher_logits.float() / tau, dim=-1)
    s = torch.log_softmax(student_logits.float() / tau, dim=-1)
    kl = torch.sum(torch.exp(t) * (t - s), dim=-1)
    return kl.mean() * tau * tau


def skipclip_loss(student_loss: torch.Tensor, distill: torch.Tensor,
                  alpha: float = 0.9) -> torch.Tensor:
    """Paper Eq. 2 (sign corrected: both terms are minimised losses):
    L = alpha * L_S + (1 - alpha) * L_D."""
    return alpha * student_loss + (1.0 - alpha) * distill
