"""The port on a CUDA device: the correlation kernel's wrapper and the slice.

Every test here needs a GPU and skips without one (decided in the ``device``
fixture, never at import).  On a machine with a card and no JAX, run them as

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py configures JAX, which this file does not
use).  Float32 comparisons switch TF32 off for cuDNN and matmul.
"""

import importlib

import pytest
import torch

from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig, inference_flow
from unopticalflow_tpu_torch.ops import correlation_cuda
from unopticalflow_tpu_torch.ops.cost_volume import cost_volume, cost_volume_reference
from unopticalflow_tpu_torch.utils.device import resolve_device

# the module, not the function that ops/__init__.py re-exports under its name
cost_volume_mod = importlib.import_module("unopticalflow_tpu_torch.ops.cost_volume")


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield resolve_device("cuda")
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


def _pair(shape, device, dtype=torch.float32, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=device).to(dtype),
            torch.randn(shape, generator=g, device=device).to(dtype))


@pytest.mark.parametrize("shape", [(2, 5, 7, 33), (1, 16, 1, 1), (3, 40, 9, 70)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, (1e-5, 1e-6)),
                                       (torch.bfloat16, (2e-2, 2e-2))])
def test_kernel_matches_plain(device, shape, dtype, tol):
    f1, f2 = _pair(shape, device, dtype)
    before = correlation_cuda.launches
    got = correlation_cuda.correlation(f1, f2, 4)
    torch.cuda.synchronize()
    assert correlation_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == (shape[0], 81) + shape[2:]
    torch.testing.assert_close(got, cost_volume_reference(f1, f2, 4), rtol=tol[0], atol=tol[1])


def test_wrapper_rejects_what_the_kernel_does_not_take(device):
    f1, f2 = _pair((1, 4, 8, 8), device)
    before = correlation_cuda.launches
    with pytest.raises(TypeError):
        correlation_cuda.correlation(f1.half(), f2.half(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        correlation_cuda.correlation(f1.transpose(2, 3), f2.transpose(2, 3), 4)
    with pytest.raises(ValueError, match="md=4"):
        correlation_cuda.correlation(f1, f2, 3)
    with pytest.raises(ValueError, match="shapes"):
        correlation_cuda.correlation(f1, f2[:, :2].contiguous(), 4)
    with pytest.raises(ValueError, match="CUDA"):
        correlation_cuda.correlation(f1.cpu(), f2.cpu(), 4)
    assert correlation_cuda.launches == before


def test_backward_is_not_silently_plain(device):
    f1, f2 = _pair((1, 4, 8, 8), device)
    f1.requires_grad_(True)
    out = cost_volume(f1, f2, 4)
    with pytest.raises(NotImplementedError, match="_corr_df1_kernel"):
        out.sum().backward()


def test_slice_goes_through_the_kernel(device, monkeypatch):
    """inference_flow on CUDA: 5 launches, never the plain version, and the
    same flow as the model with the plain correlation."""
    model = FlowModel(FlowModelConfig(), device=device, scheme="pwc",
                      generator=torch.Generator().manual_seed(0))
    g = torch.Generator(device=device).manual_seed(1)
    i1 = torch.rand(2, 64, 128, 3, generator=g, device=device)
    i2 = torch.rand(2, 64, 128, 3, generator=g, device=device)
    with torch.inference_mode():
        want = inference_flow(model, i1, i2, corr_fn=cost_volume_reference)

        def no_plain(*a, **k):
            raise AssertionError("a CUDA tensor reached cost_volume_reference")

        monkeypatch.setattr(cost_volume_mod, "cost_volume_reference", no_plain)
        before = correlation_cuda.launches
        got = inference_flow(model, i1, i2)
        torch.cuda.synchronize()
    assert correlation_cuda.launches == before + 5
    assert got.shape == (2, 64, 128, 2) and got.dtype == torch.float32
    peak = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * (1 + peak)
