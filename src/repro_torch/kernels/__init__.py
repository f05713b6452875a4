"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``, ``sm_90a``), the
port's counterparts of the reference's Pallas kernels: flash_attention
(prefill), paged_attention (the GQA and MLA decode and chunk reads of
the paged arena), qmatmul and qconv1d (quantized serving), ssd_scan
(Mamba-2). ``ops.py`` dispatches each call: the kernel on a CUDA
tensor, its plain PyTorch version (``ref.py``) on a CPU tensor, and a
launch counter per kernel and route. ``_build.py`` builds a kernel with
nvcc at its first launch, never at import, so this package imports
without a toolkit or a card."""
__all__: list = []
