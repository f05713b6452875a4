"""Quickstart on the PyTorch port: the RUBICON pipeline in ~90 lines.

1. QABAS searches a (tiny) quantization-aware space for a basecaller.
2. The derived model trains briefly on simulated squiggles.
3. Weights are quantized per the searched policy and a read is basecalled.
4. The trained basecaller SERVES a stream of reads through the
   continuous-batching engine (BasecallerRunner: squiggle chunks in,
   bases out — same scheduler that serves the LM zoo).

The twin of ``examples/quickstart.py``, on ``repro_torch``. Runs on
CUDA; ``--device cpu`` runs it on the CPU.

Run: PYTHONPATH=src python examples/quickstart_torch.py \
         [--search-steps 6] [--train-steps 200] [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core.qabas.search import (QABASConfig, derive_config,
                                           run_search)
from repro_torch.core.qabas.space import TINY_SPACE
from repro_torch.core.quant.policy import (quantize_tree, tree_map,
                                           tree_size_bytes)
from repro_torch.data.align import identity
from repro_torch.data.squiggle import (SquiggleConfig, batches, normalize,
                                       pore_table, simulate_read)
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.basecaller import model as bc
from repro_torch.models.basecaller.ctc import greedy_decode
from repro_torch.serving.engine import Request
from repro_torch.training.optimizer import AdamWConfig, init_opt_state

SIM = SquiggleConfig(chunk_len=512, k=3, dwell_jitter=False, noise=0.08,
                     drift=0.0, mean_dwell=8.0)


def data(device):
    for b in batches(SIM, 8):
        yield {k: torch.as_tensor(v).to(device) for k, v in b.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--search-steps", type=int, default=6)
    ap.add_argument("--train-steps", type=int, default=200)
    ap.add_argument("--serve-reads", type=int, default=6)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print("== 1. QABAS search (reduced space; full space is "
          f"{TINY_SPACE.size():.1e} options here, ~1.8e32 at paper scale)")
    qc = QABASConfig(steps=args.search_steps, channels=32, chunk=512)
    _, arch, hist = run_search(torch.Generator().manual_seed(0), TINY_SPACE,
                               qc, data(device), device=device)
    cfg = derive_config(arch, TINY_SPACE, channels=32)
    print(f"   derived: {cfg.n_blocks} blocks, kernels={cfg.kernel_sizes}, "
          f"quant={[o for o in cfg.quant.overrides[:3]]}...")
    trace = [f"{lat * 1e6:.2f}us" for lat in hist["latency"][:5]]
    print(f"   search latency trace: {trace}")

    print("== 2. train the derived basecaller on simulated squiggles")
    params = tree_map(lambda t: t.to(device), api.init_params(
        torch.Generator().manual_seed(0), cfg))
    opt = AdamWConfig(lr=5e-3, total_steps=max(args.train_steps, 1),
                      warmup_steps=5)
    step = api.make_train_step(cfg, opt, n_micro=1)
    carry = api.TrainCarry(params, init_opt_state(params, opt),
                           tree_map(lambda t: t.to(device),
                                    api.init_model_state(cfg)))
    it = data(device)
    for i in range(args.train_steps):
        carry, m = step(carry, next(it))
        if (i + 1) % 50 == 0 or i + 1 == args.train_steps:
            print(f"   step {i+1}: ctc loss {float(m['loss']):.2f}")

    print("== 3. quantize per searched policy and basecall")
    q = quantize_tree(carry.params, cfg.quant, min_size=64)
    fp = tree_size_bytes(carry.params)
    print(f"   model size: {fp/1e3:.0f} kB fp32 -> "
          f"{tree_size_bytes(q)/1e3:.0f} kB mixed-precision")
    b = next(it)
    with torch.inference_mode():
        logp, _ = bc.forward(carry.params, carry.model_state, b["signal"],
                             cfg, train=False)
    calls = greedy_decode(logp.cpu().numpy())
    labels = b["labels"].cpu().numpy()
    lengths = b["label_lengths"].cpu().numpy()
    ids = [identity(c, labels[i][: int(lengths[i])])
           for i, c in enumerate(calls)]
    print(f"   read identity on fresh reads: {np.mean(ids):.3f}")

    print("== 4. serve reads through the continuous-batching engine "
          "(BasecallerRunner)")
    engine = api.make_serving_engine(carry.params, cfg, device=device,
                                     n_slots=2, chunk_samples=512,
                                     model_state=carry.model_state)
    rs = np.random.RandomState(7)
    table = pore_table(k=SIM.k)
    reads = []
    for i in range(args.serve_reads):
        sig, seq = simulate_read(rs, SIM, table, int(rs.randint(40, 90)))
        reads.append(seq + 1)           # base ids 1..4 (0 = CTC blank)
        engine.submit(Request(rid=i, signal=normalize(sig)))
    done = engine.run()
    s = engine.metrics.summary()
    serve_ids = [identity(np.asarray(done[i].out_tokens, np.int64), reads[i])
                 for i in range(args.serve_reads)]
    print(f"   served {s['requests_done']} reads / "
          f"{s['generated_tokens']} bases "
          f"({s['tokens_per_s']:.0f} bases/s, slot occupancy "
          f"{s['slot_occupancy']:.2f}/2); identity {np.mean(serve_ids):.3f}")
    print("done.")


if __name__ == "__main__":
    main()
