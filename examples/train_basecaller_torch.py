"""End-to-end training on the PyTorch port: train a basecaller for a few
hundred steps with the production loop — checkpointing/auto-resume,
async saves, optional int8 gradient compression — then report held-out
read identity.

The twin of ``examples/train_basecaller.py``, on ``repro_torch``. Runs
on CUDA; ``--device cpu`` runs it on the CPU.

Run:  PYTHONPATH=src python examples/train_basecaller_torch.py \
          [--arch rubicall] [--steps 300] [--grad-compress] [--device cpu]
Kill it mid-run and run it again: it resumes from the latest valid
checkpoint.
"""
import argparse
import os
import tempfile

from repro_torch.config import get_config
from repro_torch.data.squiggle import SquiggleConfig, batches
from repro_torch.training.evaluate import eval_identity
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import TrainLoopConfig, run

SIM = SquiggleConfig(chunk_len=512, k=3, dwell_jitter=False, noise=0.08,
                     drift=0.0, mean_dwell=8.0)


def data():
    """Numpy batches; the loop moves each to the device as it takes it."""
    yield from batches(SIM, 8)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rubicall")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_basecaller_ckpt"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch + "-smoke")
    opt = AdamWConfig(lr=5e-3, total_steps=args.steps, warmup_steps=5)
    loop = TrainLoopConfig(
        steps=args.steps, log_every=25, ckpt_every=100,
        ckpt_dir=args.ckpt_dir,
        grad_compress_bits=8 if args.grad_compress else 0)
    out = run(cfg, opt, loop, data(), device=args.device)
    for row in out["history"]:
        print(row)

    ident = eval_identity(cfg, out["carry"].params,
                          out["carry"].model_state)
    print(f"held-out read identity: {ident:.3f}")


if __name__ == "__main__":
    main()
