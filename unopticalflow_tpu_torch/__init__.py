"""PyTorch/CUDA port of tpu-unflow, aimed at one NVIDIA H100.

The JAX package ``unopticalflow_tpu`` is the reference: every module here is
held against its counterpart on the same inputs, with weights moved across by
``utils.convert.load_jax_params``.  This package imports ``torch`` and never
``jax``, and nothing of the JAX package: it keeps its own copies of the host
modules it needs (config, visualizer, datasets, flowlib, the weight-key
mapping).

Layout:
    ops/        cost volume and its backward, photometric pack, regularizer
                pack (plain PyTorch + the hand-written CUDA kernels and their
                wrappers), pyramid, SSIM, warp, resize, the kernels' nvcc build
    models/     conv blocks, feature encoder, PWC decoder, FlowModel with
                inference_flow and the training forward, the loss stack
    training/   loss weights, Adam, the training step
    evaluation/ KITTI and Sintel ground truth and metrics, flow file I/O
    data/       the datasets, BatchLoader, device_prefetch, synthetic snippets,
                the raw-data preparers
    utils/      device selection, config, logging, weight and Adam-state
                conversion, checkpoints (.pth, the JAX package's .ckpt through
                a plain-Python flax msgpack codec, asynchronous saves)
    csrc/       CUDA C++ sources, built with nvcc at first use
    serve.py    the batching flow server and its HTTP handler
    train.py    the trainer (--mode flow, with the interleaved evaluation)
    test.py     the KITTI and Sintel flow evaluation, the demo, export_pth
    probe.py    serving and training measurements on one CUDA device
"""

__version__ = "0.1.0"
