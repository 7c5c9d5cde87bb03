"""The port's on-device snippet generator
(``unopticalflow_tpu_torch/benchmarks/synth_device_gen.py``) on a CPU
``torch.Generator``, held to the host generator as
``tests/test_synth_device_gen.py`` holds the JAX one: shapes and range,
motion bounds and regions, the exact-warp invariant and the moments against
the numpy generator (the JAX test's 0.05 / 0.04), plus every bound of the
per-snippet integer draws (whose bounds are tensors) reached and never
crossed over a seed sweep, one seed giving one batch, and the moments
against the JAX device generator too."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from unopticalflow_tpu_torch.benchmarks import synthetic_epe
from unopticalflow_tpu_torch.benchmarks.synth_device_gen import (
    DRAWS,
    draws,
    make_device_batch,
    make_snippet_device,
    randint,
)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks.synth_device_gen import make_device_batch as jax_make_device_batch  # noqa: E402

H, W = 64, 128


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def batch():
    return tuple(x.numpy() for x in make_device_batch(_gen(7), 6, H, W, max_bg=2, max_fg=4))


def test_shapes_and_range(batch):
    stacked, flow, nonocc = batch
    assert stacked.shape == (6, 3 * H, W, 3) and stacked.dtype == np.float32
    assert flow.shape == (6, H, W, 2) and flow.dtype == np.float32
    assert nonocc.shape == (6, H, W) and nonocc.dtype == bool
    assert 0.0 <= stacked.min() and stacked.max() <= 1.0
    assert stacked.std() > 0.05  # contrast-normalised textures: a real spread


def test_motion_bounds_and_regions(batch):
    stacked, flow, nonocc = batch
    assert np.all(flow == np.round(flow))  # integer motions
    bg = flow[:, :1, :1]  # the corner is always background
    assert np.abs(bg).max() <= 2
    assert np.abs(flow).max() <= 4
    fg_frac = (np.abs(flow - bg).max(-1) > 0).mean(axis=(1, 2))
    # rh in [H/4, H/2], rw in [W/6, W/3]: area within [1/24, 1/6] (zero only
    # where the foreground moves as the background does)
    assert fg_frac.max() <= 1 / 6 + 1e-6
    assert fg_frac.sum() > 0


@pytest.mark.parametrize("hw,max_bg,max_fg", [((64, 128), 2, 4), ((64, 64), 3, 16)])
def test_every_bound_of_the_draws_is_reached_and_never_crossed(hw, max_bg, max_fg):
    h, w = hw
    m = min(max_fg, h // 8, w // 8)
    d = {k: [] for k in DRAWS}
    for seed in range(4):  # a seed sweep, 2000 snippets a seed
        for k, v in draws(_gen(seed), 2000, h, w, max_bg, max_fg).items():
            d[k].append(v)
    d = {k: torch.cat(v) for k, v in d.items()}
    lo = {"u_b": -max_bg, "v_b": -max_bg, "u_f": -m, "v_f": -m, "rh": h // 4, "rw": w // 6}
    hi = {"u_b": max_bg, "v_b": max_bg, "u_f": m, "v_f": m, "rh": h // 2, "rw": w // 3}
    for k in lo:  # the constant bounds, inclusive: each end drawn
        assert int(d[k].min()) == lo[k] and int(d[k].max()) == hi[k], k
    # the rectangle's corner: bounds that depend on the motion and the size
    for corner, motion, size, extent in (("ry", "v_f", "rh", h), ("rx", "u_f", "rw", w)):
        low = d[motion].abs() + 1
        high = extent - d[size] - d[motion].abs() - 1  # inclusive
        assert bool((d[corner] >= low).all()) and bool((d[corner] <= high).all()), corner
        assert bool((d[corner] == low).any()) and bool((d[corner] == high).any()), corner
        # inside the frame at every t = -1, 0, 1
        for t in (-1, 0, 1):
            start = d[corner] + t * d[motion]
            assert bool((start >= 0).all()) and bool((start + d[size] <= extent).all())


def test_randint_reaches_both_ends_of_tensor_bounds():
    lo = torch.tensor([-3, 0, 5, 7]).repeat(5000)
    hi = torch.tensor([4, 1, 9, 8]).repeat(5000)
    v = randint(_gen(0), lo, hi).reshape(5000, 4)
    assert v.dtype == torch.int64
    assert v.min(0).values.tolist() == [-3, 0, 5, 7]
    assert v.max(0).values.tolist() == [3, 0, 8, 7]


def test_exact_warp_invariant(batch):
    """frame_{t+1}[p + flow(p)] == frame_t[p] on non-occluded pixels: the
    motions are integers and every frame crops the same smoothed texture."""
    stacked, flow, nonocc = batch
    ys, xs = np.mgrid[0:H, 0:W]
    for i in range(len(stacked)):
        f_t = stacked[i, H:2 * H]
        f_n = stacked[i, 2 * H:]
        dy = ys + flow[i, ..., 1].astype(int)
        dx = xs + flow[i, ..., 0].astype(int)
        ok = nonocc[i]
        np.testing.assert_allclose(f_n[dy[ok], dx[ok]], f_t[ok], rtol=0, atol=1e-6)
        # occluded background pixels land on the moved foreground: they differ
        occ = ~ok & (dy >= 0) & (dy < H) & (dx >= 0) & (dx < W)
        if occ.any():
            diff = np.abs(f_n[dy[occ], dx[occ]] - f_t[occ]).max(-1)
            assert (diff > 1e-4).mean() > 0.5


def test_distribution_matches_host_generator():
    dev = make_device_batch(_gen(3), 8, H, W, max_bg=2, max_fg=4)[0].numpy()
    host = synthetic_epe.make_batch(np.random.RandomState(3), 8, H, W, max_bg=2, max_fg=4)[0]
    # the same support and close first and second moments (the JAX test's bounds)
    assert abs(dev.mean() - host.mean()) < 0.05
    assert abs(dev.std() - host.std()) < 0.04


def test_distribution_matches_the_jax_device_generator():
    import jax

    dev = make_device_batch(_gen(3), 8, H, W, max_bg=2, max_fg=4)[0].numpy()
    jx = np.asarray(jax_make_device_batch(jax.random.PRNGKey(3), 8, H, W, max_bg=2,
                                          max_fg=4)[0])
    assert jx.shape == dev.shape and jx.dtype == dev.dtype
    assert abs(dev.mean() - jx.mean()) < 0.05
    assert abs(dev.std() - jx.std()) < 0.04


def test_one_seed_gives_one_batch_and_the_stream_moves_on():
    a = make_device_batch(_gen(11), 3, H, W, tex_power=1.0)
    b = make_device_batch(_gen(11), 3, H, W, tex_power=1.0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    gen = _gen(11)
    first = make_device_batch(gen, 3, H, W, tex_power=1.0)[0]
    second = make_device_batch(gen, 3, H, W, tex_power=1.0)[0]
    assert torch.equal(first, a[0]) and not torch.equal(first, second)
    one = make_snippet_device(_gen(11), H, W, tex_power=1.0)
    for x, y in zip(one, make_device_batch(_gen(11), 1, H, W, tex_power=1.0)):
        assert torch.equal(x, y[0])
