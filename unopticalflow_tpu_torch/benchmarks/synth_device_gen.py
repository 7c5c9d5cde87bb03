"""On-device synthetic snippet generator for the learning harness.

The port's counterpart of ``benchmarks/synth_device_gen.py``: the
generative process of ``synthetic_epe.make_snippet`` (a multi-octave
texture, an integer background translation, an independently translating
textured foreground rectangle, frames at t-1, t, t+1) as torch operations on
the device, a whole batch at once, drawing from a ``torch.Generator`` that
the caller passes.  The numpy generator runs on one host core; this one
gives fresh data every step at the device's speed (``synthetic_epe
--device-gen``; ``chip_smoke.py`` times both on the card).

The random streams differ from the host generator's (Philox against the
Mersenne twister), so batches are not bit-equal to it; what holds is the
distribution: the same octave mix, motion and rectangle bounds, box
smoothing and contrast normalisation, and the exact-warp invariant (frame
t+1 sampled at x + flow equals frame t on non-occluded pixels: the motions
are integers and every frame crops the same texture).
``tests/test_torch_device_gen.py`` holds it to the numpy generator as
``tests/test_synth_device_gen.py`` holds the JAX one.

    make_device_batch(gen, batch, h, w, max_bg=4, max_fg=8, tex_power=0.5)
        -> (B, 3h, w, 3) float32 frames in [0, 1], (B, h, w, 2) flow,
           (B, h, w) bool non-occluded mask, on ``gen``'s device
    make_snippet_device(gen, h, w, ...) -> one snippet, the batch axis dropped
"""

from __future__ import annotations

import torch

# the generator's per-snippet integer draws, in the order they are drawn
DRAWS = ("u_b", "v_b", "u_f", "v_f", "rh", "rw", "ry", "rx")


def randint(gen: torch.Generator, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """One int64 uniform on [lo, hi) per element of the int64 bound tensors.

    ``torch.randint`` takes Python bounds only, so the draw is a float64
    uniform u in [0, 1) scaled to lo + floor(u * (hi - lo)); the clamp keeps
    the rare u * n that rounds up to n inside.  Needs hi > lo everywhere.
    """
    u = torch.rand(lo.shape, generator=gen, device=gen.device, dtype=torch.float64)
    k = torch.floor(u * (hi - lo).double()).long()
    return lo + torch.minimum(k, hi - lo - 1)


def _texture(gen: torch.Generator, batch: int, h: int, w: int, octaves: int,
             power: float) -> torch.Tensor:
    """(B, h, w, 3) multi-octave textures: the host ``_texture`` per snippet."""
    dev = gen.device
    t = torch.zeros((batch, h, w, 3), dtype=torch.float32, device=dev)
    for o in range(octaves):
        s = 2**o
        small = torch.rand((batch, h // s + 2, w // s + 2, 3), generator=gen, device=dev)
        up = small.repeat_interleave(s, 1).repeat_interleave(s, 2)[:, :h, :w]
        t = t + float(s**power) * up
    # the light box smooth with wrap-around (the host's np.roll)
    t = (t + t.roll(1, 1) + t.roll(-1, 1) + t.roll(1, 2) + t.roll(-1, 2)) / 5.0
    t = t - t.amin((1, 2, 3), keepdim=True)
    top = t.amax((1, 2, 3), keepdim=True).clamp_min(1e-6)
    # float32 rounding can land ~1e-9 outside [0, 1] after the divide
    return (t / top).clamp(0.0, 1.0)


def draws(gen: torch.Generator, batch: int, h: int, w: int, max_bg: int = 4,
          max_fg: int = 8) -> dict:
    """The per-snippet integers of ``make_device_batch``: (B,) int64 each.

    Background motion (u_b, v_b) in [-max_bg, max_bg]; foreground motion
    (u_f, v_f) in [-m, m] with m = min(max_fg, h // 8, w // 8); the
    rectangle's size rh in [h/4, h/2], rw in [w/6, w/3] and its corner at t,
    ry in [|v_f| + 1, h - rh - |v_f|), rx in [|u_f| + 1, w - rw - |u_f|),
    so that it stays inside the frame at every t.
    """
    max_fg = min(max_fg, h // 8, w // 8)
    dev = gen.device

    def const(v):
        return torch.full((batch,), v, dtype=torch.int64, device=dev)

    out = {}
    for name, m in (("u_b", max_bg), ("v_b", max_bg), ("u_f", max_fg), ("v_f", max_fg)):
        out[name] = randint(gen, const(-m), const(m + 1))
    out["rh"] = randint(gen, const(h // 4), const(h // 2 + 1))
    out["rw"] = randint(gen, const(w // 6), const(w // 3 + 1))
    out["ry"] = randint(gen, out["v_f"].abs() + 1, h - out["rh"] - out["v_f"].abs())
    out["rx"] = randint(gen, out["u_f"].abs() + 1, w - out["rw"] - out["u_f"].abs())
    return out


def make_device_batch(gen: torch.Generator, batch: int, h: int, w: int, max_bg: int = 4,
                      max_fg: int = 8, tex_power: float = 0.5, return_draws: bool = False):
    """``batch`` fresh snippets on ``gen``'s device (see the module).

    Returns (stacked (B, 3h, w, 3) float32, flow_gt (B, h, w, 2) float32,
    nonocc (B, h, w) bool), and with ``return_draws`` also ``draws``' dict.
    """
    d = draws(gen, batch, h, w, max_bg, max_fg)
    pad = 2 * max(max_bg, min(max_fg, h // 8, w // 8)) + 2
    big = _texture(gen, batch, h + 2 * pad, w + 2 * pad, octaves=6, power=tex_power)
    # the foreground texture at its largest extent; the mask crops it to (rh, rw)
    fg_tex = _texture(gen, batch, h // 2 + 1, w // 3 + 1, octaves=4, power=tex_power)

    dev = gen.device
    b = torch.arange(batch, device=dev)[:, None, None]
    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None, :]

    def col(name):
        return d[name][:, None, None]

    frames, fg_masks = [], []
    for k in (-1, 0, 1):
        fr = big[b, ys + pad - k * col("v_b"), xs + pad - k * col("u_b")]
        fy, fx = col("ry") + k * col("v_f"), col("rx") + k * col("u_f")
        m = (ys >= fy) & (ys < fy + col("rh")) & (xs >= fx) & (xs < fx + col("rw"))
        fg = fg_tex[b, (ys - fy).clamp(0, h // 2), (xs - fx).clamp(0, w // 3)]
        frames.append(torch.where(m[..., None], fg, fr))
        fg_masks.append(m)

    uv_f = torch.stack([d["u_f"], d["v_f"]], -1).float()[:, None, None]
    uv_b = torch.stack([d["u_b"], d["v_b"]], -1).float()[:, None, None]
    flow_gt = torch.where(fg_masks[1][..., None], uv_f, uv_b)

    # centre background pixels whose destination at t+1 the foreground covers,
    # or that leave the frame, are occluded; the foreground stays visible
    dst_y = ys + flow_gt[..., 1].long()
    dst_x = xs + flow_gt[..., 0].long()
    inside = (dst_y >= 0) & (dst_y < h) & (dst_x >= 0) & (dst_x < w)
    covered = fg_masks[2][b, dst_y.clamp(0, h - 1), dst_x.clamp(0, w - 1)] & inside \
        & ~fg_masks[1]
    nonocc = inside & ~covered
    out = (torch.cat(frames, 1), flow_gt, nonocc)
    return (*out, d) if return_draws else out


def make_snippet_device(gen: torch.Generator, h: int, w: int, max_bg: int = 4,
                        max_fg: int = 8, tex_power: float = 0.5):
    """One snippet: (3h, w, 3) frames, (h, w, 2) flow, (h, w) non-occluded mask."""
    return tuple(x[0] for x in make_device_batch(gen, 1, h, w, max_bg, max_fg, tex_power))
