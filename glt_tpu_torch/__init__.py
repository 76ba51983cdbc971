"""glt_tpu_torch: the PyTorch/CUDA port of glt_tpu for NVIDIA Hopper.

Same module layout and names as ``glt_tpu``; plain tensor code is
PyTorch and every kernel of the TPU package is a CUDA kernel written for
``sm_90a`` (``csrc/``), built on first use (``ops/build.py``). Public
entry points run on ``cuda`` unless the caller passes ``device='cpu'``,
where each kernel wrapper runs its plain PyTorch version instead.
"""
