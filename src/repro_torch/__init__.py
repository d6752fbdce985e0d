"""PyTorch + CUDA port of the DS-CIM serving stack (``src/repro`` is the JAX
reference it mirrors module for module).

Entry points (``launch.serve.serve_batch``,
``launch.serve.serve_continuous``, ``models.lm.init_params``) run on CUDA
unless the caller passes ``device="cpu"``; with no GPU and no explicit CPU
request they raise (``device.resolve_device``).  On CUDA
tensors the two hot-path operations launch hand-written Hopper kernels
(``kernels/csrc``); on CPU tensors they run their plain PyTorch versions.
"""
