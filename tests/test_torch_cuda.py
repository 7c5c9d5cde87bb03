"""The port on a CUDA device: the kernels' wrappers and the two slices.

Every test here needs a GPU and skips without one (decided in the ``device``
fixture, never at import).  On a machine with a card and no JAX, run them as

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py configures JAX, which this file does not
use).  Float32 comparisons switch TF32 off for cuDNN and matmul.

Tolerances: correlation forward and backward in float32 rtol 1e-5 / atol
1e-6 (only the order of the float32 sums differs), bfloat16 2e-2 (the JAX
package's benchmarks/PALLAS_VALIDATE.json).  Photometric pack in float32:
sums rtol 1e-4 (sums over every pixel in another order), weights 1e-5,
d(flow) within 1e-4 of its largest value.  In bfloat16, sums and weights
within 2e-2 of the plain version on the same inputs (the plain version
rounds the warped image and img * w to bfloat16, the kernel does not), and
everything at the float32 tolerances against the plain version run in
float32 on the widened images, which is what the kernel computes.  A whole
step: losses rtol 1e-4, gradients by relative L2 norm (the plain warp's
backward scatters with atomics, so elementwise maxima are not
reproducible), as set out in ``test_train_step_kernels_match_plain``.
Regularizer pack: sums rtol 1e-4 (float32 sums in another order), d(flow)
within 1e-4 of its largest value; with bfloat16 images the same tolerances
against the plain version on the same inputs (both widen the image to
float32), and the zero pattern of d(flow) identical (the second differences
round as the plain version's, so sign(0) = 0 lands on the same positions).
"""

import importlib

import numpy as np
import pytest
import torch

from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig, inference_flow
from unopticalflow_tpu_torch.ops import correlation_cuda, photometric_cuda, regularizer_cuda
from unopticalflow_tpu_torch.ops.cost_volume import (
    corr_df1_reference,
    corr_df2_reference,
    cost_volume,
    cost_volume_reference,
)
from unopticalflow_tpu_torch.ops.photometric import photometric_pack, photometric_pack_reference
from unopticalflow_tpu_torch.ops.regularizer import regularizer_pack, regularizer_pack_reference
from unopticalflow_tpu_torch.training import loss_fn, loss_weights_from_config
from unopticalflow_tpu_torch.utils.device import resolve_device

# the modules, not the functions that ops/__init__.py re-exports under their names
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


def _counts():
    return {**correlation_cuda.launches, **photometric_cuda.launches}


def _rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


CORR_SHAPES = [(2, 5, 7, 33), (1, 16, 1, 1), (3, 40, 9, 70)]
CORR_TOLS = [(torch.float32, (1e-5, 1e-6)), (torch.bfloat16, (2e-2, 2e-2))]


@pytest.mark.parametrize("shape", CORR_SHAPES)
@pytest.mark.parametrize("dtype,tol", CORR_TOLS)
def test_kernel_matches_plain(device, shape, dtype, tol):
    f1, f2 = _pair(shape, device, dtype)
    before = correlation_cuda.launches["corr_fwd"]
    got = correlation_cuda.correlation(f1, f2, 4)
    torch.cuda.synchronize()
    assert correlation_cuda.launches["corr_fwd"] == before + 1
    assert got.dtype == dtype and got.shape == (shape[0], 81) + shape[2:]
    torch.testing.assert_close(got, cost_volume_reference(f1, f2, 4), rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("shape", CORR_SHAPES)
@pytest.mark.parametrize("dtype,tol", CORR_TOLS)
def test_backward_kernels_match_plain(device, shape, dtype, tol):
    f1, f2 = _pair(shape, device, dtype)
    g = torch.randn((shape[0], 81) + shape[2:], device=device).to(dtype)
    before = _counts()
    df1 = correlation_cuda.corr_df1(g, f2, 4)
    df2 = correlation_cuda.corr_df2(g, f1, 4)
    torch.cuda.synchronize()
    after = _counts()
    assert after["corr_bwd_df1"] == before["corr_bwd_df1"] + 1
    assert after["corr_bwd_df2"] == before["corr_bwd_df2"] + 1
    assert df1.dtype == df2.dtype == dtype and df1.shape == df2.shape == f1.shape
    torch.testing.assert_close(df1, corr_df1_reference(g, f2, 4), rtol=tol[0], atol=tol[1])
    torch.testing.assert_close(df2, corr_df2_reference(g, f1, 4), rtol=tol[0], atol=tol[1])


def test_wrapper_rejects_what_the_kernel_does_not_take(device):
    f1, f2 = _pair((1, 4, 8, 8), device)
    g = torch.zeros((1, 81, 8, 8), device=device)
    before = _counts()
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
    with pytest.raises(ValueError, match="gradient"):
        correlation_cuda.corr_df1(g[:, :80].contiguous(), f2, 4)
    with pytest.raises(TypeError):
        correlation_cuda.corr_df2(g.bfloat16(), f1, 4)
    with pytest.raises(ValueError, match="CUDA"):
        photometric_cuda.photo_fwd(f1[:, :3].cpu(), f1[:, :3], f2[:, :2], f2[:, :2], f1[:, :3])
    assert _counts() == before


def test_backward_is_not_silently_plain(device, monkeypatch):
    """The cost volume of CUDA tensors backpropagates through the df1/df2
    kernels, never the plain versions, and matches the plain backward."""
    f1, f2 = _pair((2, 6, 9, 40), device)
    g = torch.randn((2, 81, 9, 40), device=device)
    want = (corr_df1_reference(g, f2, 4), corr_df2_reference(g, f1, 4))

    def no_plain(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain correlation")

    for name in ("cost_volume_reference", "corr_df1_reference", "corr_df2_reference"):
        monkeypatch.setattr(cost_volume_mod, name, no_plain)
    a, b = f1.clone().requires_grad_(True), f2.clone().requires_grad_(True)
    before = _counts()
    cost_volume(a, b, 4).backward(g)
    torch.cuda.synchronize()
    after = _counts()
    assert [after[k] - before[k] for k in ("corr_fwd", "corr_bwd_df1", "corr_bwd_df2")] == [1, 1, 1]
    torch.testing.assert_close(a.grad, want[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(b.grad, want[1], rtol=1e-5, atol=1e-6)

    # only the inputs that need a gradient get a kernel
    a = f1.clone().requires_grad_(True)
    before = _counts()
    cost_volume(a, f2, 4).backward(g)
    torch.cuda.synchronize()
    after = _counts()
    assert after["corr_bwd_df1"] == before["corr_bwd_df1"] + 1
    assert after["corr_bwd_df2"] == before["corr_bwd_df2"]


def _photo_case(b, h, w, device, dtype, seed=0):
    rng = np.random.RandomState(seed)
    imgs = [torch.from_numpy(rng.rand(b, 3, h, w).astype(np.float32)).to(device, dtype)
            for _ in range(3)]
    flows = [torch.from_numpy(rng.uniform(-5, 5, (b, 2, h, w)).astype(np.float32)).to(device)
             for _ in range(2)]
    return imgs[0], imgs[1], flows[0], flows[1], imgs[2]  # img_l, img_r, flow_b, flow_f, img


def _photo_loss(out):
    # the downstream shape of the real losses: sums normalised by s_w (no gradient)
    return (out["s_dw"] / (out["s_w"] + 1.0)).sum() + (out["s_cl"] / (out["s_w"] + 1.0)).sum()


def _photo_run(fn, img_l, img_r, flow_b, flow_f, img):
    fb = flow_b.clone().requires_grad_(True)
    ff = flow_f.clone().requires_grad_(True)
    out = fn(img_l, img_r, fb, ff, img)
    _photo_loss(out).backward()
    return out, fb.grad, ff.grad


@pytest.mark.parametrize("shape", [(2, 16, 32), (1, 13, 45), (2, 64, 208)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_photometric_kernels_match_plain(device, shape, dtype):
    case = _photo_case(*shape, device, dtype)
    want, wb, wf = _photo_run(photometric_pack_reference, *case)
    before = _counts()
    got, gb, gf = _photo_run(photometric_pack, *case)
    torch.cuda.synchronize()
    after = _counts()
    assert after["photometric_fwd"] == before["photometric_fwd"] + 1
    assert after["photometric_bwd"] == before["photometric_bwd"] + 1
    b, h, w = shape
    assert got["weights"].shape == (2 * b, 1, h, w) and got["weights"].dtype == dtype
    for k in ("s_dw", "s_w", "s_cl"):
        assert got[k].shape == (2 * b,) and got[k].dtype == torch.float32
    if dtype == torch.float32:
        for k in ("s_dw", "s_w", "s_cl"):
            torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(got["weights"], want["weights"], rtol=1e-5, atol=1e-5)
        for g, r in ((gb, wb), (gf, wf)):
            assert float((g - r).abs().max()) <= 1e-4 * float(r.abs().max())
    else:
        for k in ("s_dw", "s_w", "s_cl"):
            torch.testing.assert_close(got[k], want[k], rtol=2e-2, atol=2e-2)
        assert float((got["weights"].float() - want["weights"].float()).abs().mean()) <= 2e-2
        # the kernel widens the bf16 images and computes in float32 without
        # rounding, so on the widened images it is the float32 plain version
        want32, wb32, wf32 = _photo_run(photometric_pack_reference,
                                        *(t.float() for t in case))
        for k in ("s_dw", "s_w", "s_cl"):
            torch.testing.assert_close(got[k], want32[k], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(got["weights"].float(), want32["weights"],
                                   rtol=2**-8, atol=1e-5)
        for g, r in ((gb, wb32), (gf, wf32)):
            assert float((g - r).abs().max()) <= 1e-4 * float(r.abs().max())


def test_photometric_weights_and_sw_carry_no_gradient(device):
    img_l, img_r, flow_b, flow_f, img = _photo_case(2, 16, 32, device, torch.float32)
    fb = flow_b.clone().requires_grad_(True)
    out = photometric_pack(img_l, img_r, fb, flow_f, img)
    assert not out["weights"].requires_grad and not out["s_w"].requires_grad
    (out["weights"].sum() + out["s_w"].sum() + 0.0 * out["s_dw"].sum()).backward()
    assert float(fb.grad.abs().sum()) == 0.0


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
        before = correlation_cuda.launches["corr_fwd"]
        got = inference_flow(model, i1, i2)
        torch.cuda.synchronize()
    assert correlation_cuda.launches["corr_fwd"] == before + 5
    assert got.shape == (2, 64, 128, 2) and got.dtype == torch.float32
    peak = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * (1 + peak)


PHOTO = {"loss_pixel": 0.15, "loss_ssim": 0.85, "loss_flow_smooth": 0.0, "loss_flow_consis": 0.0}


def _step_grads(model, cfg, batch, weights=None, **fns):
    model.zero_grad(set_to_none=True)
    total, means = loss_fn(model, cfg, batch, weights or loss_weights_from_config(object()), **fns)
    total.backward()
    return means, {k: p.grad.clone() for k, p in model.named_parameters()}


def _flat(grads):
    return torch.cat([grads[k].ravel() for k in sorted(grads)])


def test_train_step_kernels_match_plain(device):
    """One training step at 64x64, batch 2, float32: 5 correlation forwards, 5 + 5
    correlation backwards, 3 photometric forwards and backwards; the same losses
    as with the plain versions, the photometric losses' gradients within 1e-4,
    and the weighted total's no farther from the plain step's than the plain
    step is from itself on snippets moved by one ulp (the smoothness term's
    gradient is sign(rounding noise) between the upsampled flow's samples)."""
    cfg = FlowModelConfig()
    model = FlowModel(cfg, device=device, scheme="pwc", generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    batch = torch.from_numpy(rng.rand(2, 192, 64, 3).astype(np.float32)).to(device)
    nudged = torch.nextafter(batch, torch.full_like(batch, 2.0))
    plain = dict(corr_fn=cost_volume_reference, photo_fn=photometric_pack_reference)
    want, want_g = _step_grads(model, cfg, batch, **plain)
    _, noise_g = _step_grads(model, cfg, nudged, **plain)
    _, want_photo = _step_grads(model, cfg, batch, PHOTO, **plain)
    before = _counts()
    got, got_g = _step_grads(model, cfg, batch)
    torch.cuda.synchronize()
    after = _counts()
    assert {k: after[k] - before[k] for k in after} == {
        "corr_fwd": 5, "corr_bwd_df1": 5, "corr_bwd_df2": 5,
        "photometric_fwd": 3, "photometric_bwd": 3}
    for k in want:
        assert torch.isfinite(got[k]) and torch.isfinite(want[k])
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-6)
    _, got_photo = _step_grads(model, cfg, batch, PHOTO)
    for k in want_photo:
        assert _rel_l2(got_photo[k], want_photo[k]) <= 1e-4, k
    noise = _rel_l2(_flat(noise_g), _flat(want_g))
    assert _rel_l2(_flat(got_g), _flat(want_g)) <= max(1e-4, noise)


def test_train_step_bf16_is_finite(device):
    cfg = FlowModelConfig(compute_dtype="bfloat16", loss_dtype="bfloat16")
    model = FlowModel(cfg, device=device, scheme="pwc", generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    batch = torch.from_numpy(rng.randint(0, 256, (2, 192, 64, 3)).astype(np.uint8)).to(device)
    before = _counts()
    got, grads = _step_grads(model, cfg, batch)
    torch.cuda.synchronize()
    assert all(_counts()[k] > before[k] for k in before)
    assert all(bool(torch.isfinite(v)) for v in got.values())
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())


def _reg_case(b, h, w, device, dtype, seed=0):
    """Flows upsampled from a coarse field (second differences exactly zero
    inside the 4x4 blocks) plus sparse noise; image and weights in ``dtype``."""
    rng = np.random.RandomState(seed)
    coarse = torch.from_numpy(rng.uniform(-5, 5, (b, 4, (h + 3) // 4, (w + 3) // 4)).astype(np.float32))
    fl = torch.nn.functional.interpolate(coarse, scale_factor=4, mode="nearest")[:, :, :h, :w]
    noise = (rng.rand(b, 4, h, w) < 0.3) * rng.uniform(-1, 1, (b, 4, h, w))
    fl = (fl + torch.from_numpy(noise).float()).to(device)
    img = torch.from_numpy(rng.rand(b, 3, h, w).astype(np.float32)).to(device, dtype)
    w_fwd = torch.from_numpy(rng.rand(b, 1, h, w).astype(np.float32)).to(device, dtype)
    return fl[:, :2].contiguous(), fl[:, 2:].contiguous(), img, w_fwd


def _reg_run(fn, flow_b, flow_f, img, w_fwd, cot):
    fb = flow_b.clone().requires_grad_(True)
    ff = flow_f.clone().requires_grad_(True)
    out = fn(fb, ff, img, w_fwd)
    total = sum((out[k] * cot[k]).sum() for k in out)
    total.backward()
    return out, fb.grad, ff.grad


@pytest.mark.parametrize("shape", [(2, 16, 32), (1, 13, 45), (2, 64, 208)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_regularizer_kernels_match_plain(device, shape, dtype):
    b, h, w = shape
    case = _reg_case(b, h, w, device, dtype)
    g = torch.Generator(device=device).manual_seed(2)
    cot = {"s_sx": torch.rand(2 * b, generator=g, device=device),
           "s_sy": torch.rand(2 * b, generator=g, device=device),
           "s_consis": torch.rand(b, generator=g, device=device)}
    want, wb, wf = _reg_run(regularizer_pack_reference, *case, cot)
    before = dict(regularizer_cuda.launches)
    got, gb, gf = _reg_run(regularizer_pack, *case, cot)
    torch.cuda.synchronize()
    assert regularizer_cuda.launches == {k: v + 1 for k, v in before.items()}
    for k in ("s_sx", "s_sy", "s_consis"):
        assert got[k].shape == want[k].shape and got[k].dtype == torch.float32
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-4)
    for g_, r in ((gb, wb), (gf, wf)):
        assert float((g_ - r).abs().max()) <= 1e-4 * float(r.abs().max())
        assert torch.equal(g_ == 0, r == 0)


def test_regularizer_consis_grad_only_reaches_fwd(device):
    flow_b, flow_f, img, w_fwd = _reg_case(2, 16, 32, device, torch.float32)
    fb = flow_b.clone().requires_grad_(True)
    ff = flow_f.clone().requires_grad_(True)
    out = regularizer_pack(fb, ff, img, w_fwd)
    (out["s_consis"].sum() + 0.0 * out["s_sx"].sum()).backward()
    assert float(fb.grad.abs().max()) == 0.0 and float(ff.grad.abs().max()) > 0.0


def test_regularizer_wrapper_rejects_what_the_kernel_does_not_take(device):
    flow_b, flow_f, img, w_fwd = _reg_case(1, 8, 8, device, torch.float32)
    before = dict(regularizer_cuda.launches)
    with pytest.raises(TypeError):
        regularizer_cuda.reg_fwd(flow_b, flow_f, img.half(), w_fwd.half())
    with pytest.raises(TypeError):
        regularizer_cuda.reg_fwd(flow_b, flow_f, img, w_fwd.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        regularizer_cuda.reg_fwd(flow_b.transpose(2, 3), flow_f.transpose(2, 3),
                                 img.transpose(2, 3), w_fwd.transpose(2, 3))
    with pytest.raises(ValueError, match="weights"):
        regularizer_cuda.reg_fwd(flow_b, flow_f, img, w_fwd[:, :, :4].contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        regularizer_cuda.reg_fwd(flow_b.cpu(), flow_f, img, w_fwd)
    assert regularizer_cuda.launches == before


def test_train_step_with_regularizer_kernels_matches_plain(device):
    """``use_pallas_reg`` at 64x64, batch 2, float32: 3 + 3 regularizer
    launches per step and the losses of the plain regularizer (rtol 1e-4)."""
    cfg = FlowModelConfig(use_pallas_reg=True)
    model = FlowModel(cfg, device=device, scheme="pwc", generator=torch.Generator().manual_seed(0))
    batch = torch.from_numpy(np.random.RandomState(0).rand(2, 192, 64, 3).astype(np.float32)).to(device)
    want, _ = _step_grads(model, cfg, batch, reg_fn=regularizer_pack_reference)
    before = dict(regularizer_cuda.launches)
    got, grads = _step_grads(model, cfg, batch)
    torch.cuda.synchronize()
    assert regularizer_cuda.launches == {k: v + 3 for k, v in before.items()}
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-6)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
