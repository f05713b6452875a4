"""The PyTorch port of RUBICON, for one NVIDIA H100 (the counterpart of
the JAX package ``repro``, which has no package ``__init__``).

Layers, from the entry points down:

- ``launch``: the serving, training and dry-run command lines
  (``python -m repro_torch.launch.{serve,train,dryrun}``);
- ``serving`` and ``training``: the continuous-batching engine with its
  runners and paged KV pool; the training loop (checkpoints, int8
  gradient compression, data parallelism over a ``torch.distributed``
  group);
- ``core``: RUBICON's own methods (quantization, QABAS, SkipClip,
  distillation, pruning);
- ``models``: the basecallers and the LM families, in plain PyTorch;
- ``kernels``: the hand-written CUDA kernels for Hopper (``sm_90a``),
  each behind a wrapper in ``kernels/ops.py`` that runs its plain
  PyTorch version on a CPU tensor and launches the kernel on a CUDA one;
- ``config``, ``configs``, ``parallel``, ``analysis``, ``data``,
  ``device`` and ``bridge``: the configs, the mesh placements, the
  roofline counts, the synthetic data, the device rule and numpy
  conversion.

Invariants: the package imports neither ``jax`` nor ``repro``; an
entry point runs on CUDA unless the caller asks for the CPU, and raises
without a card; importing a module builds no kernel and starts no
process group. Importing the package imports none of its modules.
"""
__all__: list = []
