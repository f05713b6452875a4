"""Training launcher: ``python -m repro_torch.launch.train --arch
rubicall --steps 200``.

Trains a basecaller on synthetic squiggles (``data/squiggle.py``,
``--batch`` chunks of ``--seq`` samples a step) or an LM (every family:
``dense``, ``moe``, ``ssm``, ``hybrid``, ``vlm`` with stub patch
embeddings, ``audio`` with stub frames) on the synthetic Markov token
stream (``data/tokens.py``, ``--batch`` rows of ``--seq`` tokens) through the
fault-tolerant loop (``training/train_loop.py``: checkpoint/resume
every ``--ckpt-every`` steps into ``--ckpt-dir``, optional int8
gradient compression) and prints the metric history, one JSON row per
logged step. Runs on CUDA; ``--device cpu`` trains on the CPU, and
without a card and without it the launcher raises.

One device only: ``--coordinator`` (multi-host) and ``--model-parallel``
above 1 are refused.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

from repro_torch.config import get_config
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import TrainLoopConfig, run


def data_for(cfg, batch: int, seq: int):
    """Synthetic squiggle batches for a basecaller, synthetic token
    batches (with a vlm's patch embeddings or an audio arch's frames)
    for an LM (numpy; the loop moves them to the device)."""
    if cfg.family == "basecaller":
        from repro_torch.data.squiggle import SquiggleConfig, batches
        yield from batches(SquiggleConfig(chunk_len=seq), batch)
    else:
        from repro_torch.data.tokens import token_batches
        yield from token_batches(cfg, batch, seq)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="rubicall")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--grad-compress-bits", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--coordinator", default="",
                    help="host:port of a multi-host run (not ported)")
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.coordinator or args.num_hosts > 1 or args.model_parallel > 1:
        raise NotImplementedError(
            "multi-host and model-parallel training (--coordinator, "
            "--num-hosts, --model-parallel) are not ported: the port "
            "trains on one device")
    cfg = get_config(args.arch + ("-smoke" if args.smoke else ""))
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps)
    loop = TrainLoopConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                           ckpt_every=args.ckpt_every,
                           n_micro=args.n_micro,
                           grad_compress_bits=args.grad_compress_bits)
    out = run(cfg, opt_cfg, loop, data_for(cfg, args.batch, args.seq),
              device=args.device)
    for row in out["history"]:
        print(json.dumps(row))


if __name__ == "__main__":
    main()
