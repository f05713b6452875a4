"""One intra-op thread for torch in a test process.

The tier-1 run puts six xdist workers on a machine of a few cores.
torch's default, one intra-op thread a core in each worker,
oversubscribes it, and OpenMP's spinning barriers then slow the small
ops of these tests by up to two orders of magnitude (the streaming
launcher's test: 2.4 s alone, 225 s among the workers). Every
``tests/test_torch_*.py`` file imports this module, so each worker
sets it when it collects them; a subprocess that a test starts gets
:data:`SUBPROCESS_ENV` in its environment."""
import torch

torch.set_num_threads(1)

SUBPROCESS_ENV = {"OMP_NUM_THREADS": "1"}
