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
Halo-prepadded correlation kernels: the correlation's tolerances; spatial
inference at n = 2 within 1e-4 * (1 + max|flow|) of the unsharded flow
(float32; cuDNN may pick other algorithms for slabs of other heights).
Gathers: bit for bit (``torch.equal``): the row gather copies, and the
block gathers add in x's dtype in the plain versions' order.
"""

import importlib

import numpy as np
import pytest
import torch

from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig, inference_flow
from unopticalflow_tpu_torch.ops import (
    correlation_cuda,
    gather_cuda,
    photometric_cuda,
    regularizer_cuda,
)
from unopticalflow_tpu_torch.ops.cost_volume import (
    corr_df1_hpad_reference,
    corr_df1_reference,
    corr_df2_hpad_reference,
    corr_df2_reference,
    corr_fwd_hpad_reference,
    cost_volume,
    cost_volume_reference,
)
from unopticalflow_tpu_torch.ops.gather import (
    lane_gather,
    lane_gather_reference,
    row_gather,
    row_gather_reference,
    sublane_gather,
    sublane_gather_reference,
)
from unopticalflow_tpu_torch.ops.photometric import photometric_pack, photometric_pack_reference
from unopticalflow_tpu_torch.ops.regularizer import regularizer_pack, regularizer_pack_reference
from unopticalflow_tpu_torch.parallel import gather_rows, make_spatial_infer, spatial_mesh
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


# ragged shapes of the tiled kernels (tiles of 4 rows x 32 columns, channels in
# chunks of 8 forward and 16 backward): W no multiple of 32 with W % 4 == 0
# (16-byte copies) and without, H = 1, C = 1, odd C, coarse levels whose dy rows
# (forward) or channel chunks (backward) split over the grid (the second is the
# training level 6), and C no multiple of either chunk with a channel split
CORR_SHAPES = [(2, 5, 7, 33), (1, 16, 1, 1), (3, 40, 9, 70), (2, 1, 1, 45), (1, 7, 5, 100),
               (2, 13, 6, 36), (4, 196, 4, 13), (16, 196, 4, 13), (3, 37, 5, 19)]
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


@pytest.mark.parametrize("hpad", [False, True], ids=["whole", "hpad"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backward_kernels_are_deterministic(device, hpad, dtype):
    """df1 and df2 sum in a fixed order without atomics: two calls on the same
    inputs give the same bits, at a level whose channels split over the grid."""
    b, c, h, w = 16, 196, 4, 13
    halo = 8 if hpad else 0
    gen = torch.Generator(device=device).manual_seed(3)

    def rnd(*s):
        return torch.randn(s, generator=gen, device=device).to(dtype)

    g, gh, f = rnd(b, 81, h, w), rnd(b, 81, h + halo, w), rnd(b, c, h + halo, w)
    df1 = correlation_cuda.corr_df1_hpad if hpad else correlation_cuda.corr_df1
    df2 = correlation_cuda.corr_df2_hpad if hpad else correlation_cuda.corr_df2
    for kern, grad in ((df1, g), (df2, gh)):
        first = kern(grad, f, 4)
        second = kern(grad, f, 4)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


def test_backward_grid_takes_what_the_forward_takes(device):
    """The backward's grid is the forward's (z = B, or B * channel groups below
    2 blocks per SM): B * C above 65535 launches, and only H > 4 * 65535 or
    B > 65535 is refused, before any launch."""
    f1, f2 = _pair((2, 40000, 1, 3), device)
    g = torch.randn((2, 81, 1, 3), device=device)
    before = _counts()
    torch.testing.assert_close(correlation_cuda.corr_df1(g, f2, 4), corr_df1_reference(g, f2, 4),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(correlation_cuda.corr_df2(g, f1, 4), corr_df2_reference(g, f1, 4),
                               rtol=1e-5, atol=1e-6)
    after = _counts()
    assert (after["corr_bwd_df1"], after["corr_bwd_df2"]) == (before["corr_bwd_df1"] + 1,
                                                              before["corr_bwd_df2"] + 1)
    tall = torch.zeros((1, 1, 4 * 65535 + 1, 1), device=device)
    with pytest.raises(ValueError, match="cannot launch"):
        correlation_cuda.corr_df1(torch.zeros((1, 81, 4 * 65535 + 1, 1), device=device), tall, 4)
    wide = torch.zeros((65536, 1, 1, 1), device=device)
    with pytest.raises(ValueError, match="cannot launch"):
        correlation_cuda.corr_df2(torch.zeros((65536, 81, 1, 1), device=device), wide, 4)
    assert _counts() == after


HPAD = {
    "corr_fwd_hpad": (correlation_cuda.corr_fwd_hpad, corr_fwd_hpad_reference),
    "corr_bwd_df1_hpad": (correlation_cuda.corr_df1_hpad, corr_df1_hpad_reference),
    "corr_bwd_df2_hpad": (correlation_cuda.corr_df2_hpad, corr_df2_hpad_reference),
}


@pytest.mark.parametrize("shape", CORR_SHAPES)
@pytest.mark.parametrize("dtype,tol", CORR_TOLS)
@pytest.mark.parametrize("name", sorted(HPAD))
def test_hpad_kernels_match_plain(device, name, shape, dtype, tol):
    """The halo-prepadded kernels of a row-shard (its read operands carry 4
    rows above and below) against their plain versions."""
    b, c, h, w = shape
    g = torch.Generator(device=device).manual_seed(2)

    def rnd(*s):
        return torch.randn(s, generator=g, device=device).to(dtype)

    args = {"corr_fwd_hpad": (rnd(b, c, h, w), rnd(b, c, h + 8, w)),
            "corr_bwd_df1_hpad": (rnd(b, 81, h, w), rnd(b, c, h + 8, w)),
            "corr_bwd_df2_hpad": (rnd(b, 81, h + 8, w), rnd(b, c, h + 8, w))}[name]
    kern, ref = HPAD[name]
    before = _counts()
    got = kern(*args, 4)
    torch.cuda.synchronize()
    assert _counts() == {**before, name: before[name] + 1}
    assert got.dtype == dtype and got.shape == (b, 81 if name == "corr_fwd_hpad" else c, h, w)
    torch.testing.assert_close(got, ref(*args, 4), rtol=tol[0], atol=tol[1])


def test_spatial_infer_goes_through_the_hpad_kernel(device):
    """make_spatial_infer with two row-shards on this card: the unsharded flow
    within 1e-4 * (1 + max|flow|), 5 launches of each shard's hpad forward and
    none of the whole-map kernel; and a gradient through both hpad backwards."""
    model = FlowModel(FlowModelConfig(), device=device, scheme="pwc",
                      generator=torch.Generator().manual_seed(0))
    g = torch.Generator(device=device).manual_seed(1)
    i1 = torch.rand(2, 128, 128, 3, generator=g, device=device)
    i2 = torch.rand(2, 128, 128, 3, generator=g, device=device)
    fn = make_spatial_infer(model, spatial_mesh(2, devices=[device, device]))
    with torch.inference_mode():
        want = inference_flow(model, i1, i2)
        before = _counts()
        got = gather_rows(fn(i1, i2))
        torch.cuda.synchronize()
    assert _counts() == {**before, "corr_fwd_hpad": before["corr_fwd_hpad"] + 10}
    assert got.shape == want.shape and got.device == want.device
    peak = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * (1 + peak)
    before = _counts()
    gather_rows(fn(i1, i2)).square().sum().backward()
    torch.cuda.synchronize()
    after = _counts()
    assert [after[k] - before[k] for k in HPAD] == [10, 10, 10]
    assert all(bool(torch.isfinite(p.grad).all()) for p in model.parameters())


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
    with pytest.raises(ValueError, match="halo"):  # f2 without its halo rows
        correlation_cuda.corr_fwd_hpad(f1, f2, 4)
    with pytest.raises(ValueError, match="gradient"):  # df2 reads g's halo too
        correlation_cuda.corr_df2_hpad(g, torch.zeros((1, 4, 16, 8), device=device), 4)
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


# (B, H, W) at the edges of the photometric kernels' 16 x 32 tile (two adjacent
# pixels a thread, loaded as one vector where W is even and the pointers
# aligned): a whole tile, H and W no multiple of it with W odd and even, a loss
# scale, H = 1, W = 1, H = 2 (the backward's 2-pixel halo wider than the image)
PHOTO_SHAPES = [(2, 16, 32), (1, 13, 45), (2, 37, 45), (2, 64, 208), (2, 1, 40), (1, 7, 1),
                (2, 2, 50), (3, 17, 66)]


def _misalign(t):
    """t's values in a tensor whose storage starts one element into a buffer:
    contiguous, but no longer aligned to two elements."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("shape", PHOTO_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "misaligned"])
def test_photometric_kernels_match_plain(device, shape, dtype, aligned):
    case = _photo_case(*shape, device, dtype)
    if not aligned:
        case = tuple(_misalign(t) for t in case)
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


@pytest.mark.parametrize("shape", [(2, 37, 45), (2, 64, 208)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_photometric_kernels_are_deterministic(device, shape, dtype):
    """Two calls on the same inputs give the same bits (no atomics in the sums)."""
    img_l, img_r, flow_b, flow_f, img = _photo_case(*shape, device, dtype, seed=1)
    g = torch.rand(4 * shape[0], generator=torch.Generator(device=device).manual_seed(2),
                   device=device)
    runs = [(photometric_cuda.photo_fwd(img_l, img_r, flow_b, flow_f, img),
             photometric_cuda.photo_bwd(img_l, img_r, flow_b, flow_f, img, g[:2 * shape[0]],
                                        g[2 * shape[0]:])) for _ in range(2)]
    torch.cuda.synchronize()
    (f1, d1), (f2, d2) = runs
    assert all(torch.equal(a, b) for a, b in (*zip(f1, f2), *zip(d1, d2)))


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
        "photometric_fwd": 3, "photometric_bwd": 3,
        "corr_fwd_hpad": 0, "corr_bwd_df1_hpad": 0, "corr_bwd_df2_hpad": 0}
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
    assert all(_counts()[k] > before[k] for k in before if not k.endswith("_hpad"))
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


# (B, H, W) at the kernels' 16 x 32 tile's edges (chip_smoke.py's REG_RAGGED):
# H and W no multiple of the tile, odd W (scalar loads), even ragged W (vector
# loads), W = 1, 2, 3 (no x anchor, or one), H = 1, 2, 3, one exact tile, two
# tiles, 3 x 5 tiles; and the smallest loss scale of the KITTI recipe
REG_SHAPES = [(2, 16, 32), (1, 13, 45), (2, 64, 208), (2, 37, 100), (2, 21, 70), (1, 5, 1),
              (1, 7, 2), (2, 9, 3), (2, 1, 50), (1, 2, 33), (2, 3, 130), (2, 16, 64),
              (1, 33, 129)]


@pytest.mark.parametrize("shape", REG_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_regularizer_kernels_match_plain(device, shape, dtype):
    """The kernels against the plain version; each call one launch, and two
    calls on the same inputs the same bits (no atomics on floats)."""
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
    for name, call in (
            ("regularizer_fwd", lambda: regularizer_cuda.reg_fwd(*case)),
            ("regularizer_bwd", lambda: regularizer_cuda.reg_bwd(*case, cot["s_sx"], cot["s_sy"],
                                                                 cot["s_consis"]))):
        before = regularizer_cuda.launches[name]
        first, second = call(), call()
        torch.cuda.synchronize()
        assert regularizer_cuda.launches[name] == before + 2
        assert all(torch.equal(x, y) for x, y in zip(first, second))


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


# the gather probes' shapes (benchmarks/gather_probe.py, pallas_gather_probe.py)
# and ragged ones: (B, H, W, C) for the row gather, (S, W) for the block gathers
# (B, H, W, C): the probe's 12 channels (8-byte bf16 and 16-byte f32 copies),
# a ragged 5 (2-byte bf16 copies), 3 (4- and 2-byte) and a wide 128 (rows of
# more than 4 copy units)
ROW_GATHER_SHAPES = [(16, 256, 832, 12), (3, 45, 61, 5), (2, 17, 19, 3), (2, 9, 31, 128)]
BLOCK_GATHER_CASES = [("lane", (4096, 128), torch.float32), ("lane", (4096, 128), torch.bfloat16),
                      ("sublane", (8, 8192), torch.float32), ("lane", (13, 96), torch.bfloat16),
                      ("sublane", (5, 333), torch.float32)]


@pytest.mark.parametrize("shape", ROW_GATHER_SHAPES, ids=["probe", "ragged", "c3", "c128"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_row_gather_kernel_equals_plain(device, shape, dtype):
    """Bit for bit (a copy), every row of a ragged R written, one launch."""
    b, h, w, c = shape
    n = (h + 1) * (w + 1)
    rng = np.random.RandomState(c)
    img = torch.from_numpy(rng.rand(b, n, c).astype(np.float32)).to(device, dtype)
    idx_np = rng.randint(0, n, (b, h * w, 1)).astype(np.int32)
    idx_np[0, 0, 0], idx_np[-1, -1, 0] = 0, n - 1
    idx_np[0, 1, 0], idx_np[-1, 0, 0] = -3, n + 5  # out of range: clamped
    idx = torch.from_numpy(idx_np).to(device)
    before = gather_cuda.launches["row_gather"]
    got = row_gather(img, idx)
    torch.cuda.synchronize()
    assert gather_cuda.launches["row_gather"] == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (b, h * w, c)
    assert torch.equal(got, row_gather_reference(img, idx.clamp(0, n - 1)))


@pytest.mark.parametrize("kind,shape,dtype", BLOCK_GATHER_CASES,
                         ids=["lane_f32", "lane_bf16", "sublane_f32", "lane_ragged_bf16",
                              "sublane_ragged_f32"])
def test_block_gather_kernels_equal_plain(device, kind, shape, dtype):
    """Summed in x's dtype in the plain version's order: bit for bit."""
    rng = np.random.RandomState(shape[0])
    x = torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(device, dtype)
    span = shape[1] if kind == "lane" else shape[0]
    idx = torch.from_numpy(rng.randint(-span, 2 * span, shape).astype(np.int32)).to(device)
    fn, ref = ((lane_gather, lane_gather_reference) if kind == "lane"
               else (sublane_gather, sublane_gather_reference))
    name = f"{kind}_gather"
    before = gather_cuda.launches[name]
    got = fn(x, idx)
    torch.cuda.synchronize()
    assert gather_cuda.launches[name] == before + 1
    assert got.dtype == dtype and tuple(got.shape) == shape
    assert torch.equal(got, ref(x, idx))


def test_gather_wrappers_reject_what_the_kernels_do_not_take(device):
    x = torch.rand(8, 128, device=device)
    idx = torch.zeros((8, 128), dtype=torch.int32, device=device)
    img = torch.rand(2, 9, 3, device=device)
    ridx = torch.zeros((2, 4, 1), dtype=torch.int32, device=device)
    before = dict(gather_cuda.launches)
    with pytest.raises(TypeError):
        gather_cuda.row_gather(img.half(), ridx)
    with pytest.raises(TypeError):
        gather_cuda.row_gather(img, ridx.long())
    with pytest.raises(ValueError, match="idx"):
        gather_cuda.row_gather(img, ridx[:, :, 0].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        gather_cuda.lane_gather(x.T, idx.T)
    with pytest.raises(ValueError, match="CUDA"):
        gather_cuda.lane_gather(x, idx.cpu())
    with pytest.raises(ValueError, match="at most"):
        gather_cuda.lane_gather(torch.rand(1, 5000, device=device),
                                torch.zeros((1, 5000), dtype=torch.int32, device=device))
    with pytest.raises(ValueError, match="at most"):
        gather_cuda.sublane_gather(torch.rand(65, 4, device=device),
                                   torch.zeros((65, 4), dtype=torch.int32, device=device))
    assert gather_cuda.launches == before
    assert gather_cuda.row_gather(img, ridx[:, :0].contiguous()).shape == (2, 0, 3)
    assert gather_cuda.launches == before  # an empty output launches nothing


def test_float32_server_from_build_server_runs_without_tf32(device, tmp_path):
    """``serve.build_server`` at --precision float32, started from PyTorch's
    default (TF32 on for cuDNN): TF32 is off once the server is built, and
    the served flow is within the float32 tolerance of the plain-correlation
    flow of the same weights."""
    import types

    from unopticalflow_tpu_torch.serve import build_server
    from unopticalflow_tpu_torch.training import make_optimizer
    from unopticalflow_tpu_torch.utils.checkpoint import save_checkpoint

    model = FlowModel(FlowModelConfig(), device=device, scheme="pwc",
                      generator=torch.Generator().manual_seed(0))
    pth = str(tmp_path / "m.pth")
    save_checkpoint([pth], 1, model, make_optimizer(model))
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default; the fixture restores it
    torch.backends.cuda.matmul.allow_tf32 = True
    args = types.SimpleNamespace(device="cuda", precision="float32", pretrained_model=pth,
                                 spatial=1, spatial_devices=None, max_batch=2, max_wait_ms=5.0)
    server = build_server(types.SimpleNamespace(img_hw=(128, 256)), args)
    try:
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        pair = np.random.RandomState(3).rand(256, 256, 3).astype(np.float32)
        flow = server.infer(pair, timeout=300.0)
    finally:
        server.close()
    i1 = torch.from_numpy(pair[None, :128]).to(device)
    i2 = torch.from_numpy(pair[None, 128:]).to(device)
    with torch.inference_mode():
        want = inference_flow(model, i1, i2, corr_fn=cost_volume_reference)[0].cpu().numpy()
    peak = float(np.abs(want).max())
    assert flow.shape == want.shape and float(np.abs(flow - want).max()) <= 1e-4 * (1 + peak)
