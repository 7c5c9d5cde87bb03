"""PyTorch/CUDA port of tpu-unflow, aimed at one NVIDIA H100.

The JAX package ``unopticalflow_tpu`` is the reference: every module here is
held against its counterpart on the same inputs, with weights moved across by
``utils.convert.load_jax_params``.  This package imports ``torch`` and never
``jax``; it reuses only the JAX package's numpy-only host modules
(``utils.torch_convert``, ``evaluation.flowlib``).

Layout:
    ops/     cost volume (plain PyTorch + the hand-written CUDA kernel),
             warp, resize
    models/  conv blocks, feature encoder, PWC decoder, FlowModel
    utils/   device selection, weight conversion, checkpoint loading
    csrc/    CUDA C++ sources, built with nvcc at first use
    serve.py the batching flow server
    probe.py serving measurements on one CUDA device
"""

__version__ = "0.1.0"
