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

Across processes, one a device: ``--coordinator host:port --num-hosts N
--host-id i`` starts process ``i`` of ``N`` in a ``torch.distributed``
group (NCCL on ``cuda``, each process on card ``i`` modulo the cards it
sees; gloo on ``--device cpu``), and the loop trains on
``make_host_mesh(--model-parallel)`` (``launch/mesh.py``), a ``(data,
model)`` mesh: every process reads the same global batch, each data
rank takes its own rows, and a model axis above 1 splits every LM
arch over it (tensor parallelism: attention, MLA, cross-attention and
SSM heads, MLP hidden width, vocabulary and experts, each where the
axis divides it; the basecaller replicates over it). Where
``--model-parallel`` does not divide the world the model axis falls
back to 1, as the reference's does.

    python -m repro_torch.launch.train --arch rubicall --smoke --device cpu \
        --coordinator 127.0.0.1:29500 --num-hosts 2 --host-id 0 &
    python -m repro_torch.launch.train --arch rubicall --smoke --device cpu \
        --coordinator 127.0.0.1:29500 --num-hosts 2 --host-id 1
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.config import get_config
from repro_torch.launch.mesh import make_host_mesh
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
                    help="host:port of process 0's rendezvous: trains "
                    "data-parallel over --num-hosts processes")
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # without --coordinator the run is this one process, as the
    # reference's: a world of 1, whose model axis is 1 whatever
    # --model-parallel asks
    try:
        mesh = _start_group(args) if args.coordinator else None
        cfg = get_config(args.arch + ("-smoke" if args.smoke else ""))
        opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps)
        loop = TrainLoopConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                               ckpt_every=args.ckpt_every,
                               n_micro=args.n_micro,
                               grad_compress_bits=args.grad_compress_bits)
        out = run(cfg, opt_cfg, loop, data_for(cfg, args.batch, args.seq),
                  device=None if mesh is not None else args.device,
                  mesh=mesh)
    finally:
        if args.coordinator and dist.is_initialized():
            dist.destroy_process_group()
    for row in out["history"]:
        print(json.dumps(row))


def _start_group(args):
    """This process's place in the run's process group (NCCL on a card,
    gloo on the CPU), and the host mesh over it, one device a
    process."""
    from repro_torch.device import resolve_device
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(args.host_id % torch.cuda.device_count())
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{args.coordinator}",
                            rank=args.host_id, world_size=args.num_hosts)
    return make_host_mesh(args.model_parallel)


if __name__ == "__main__":
    main()
