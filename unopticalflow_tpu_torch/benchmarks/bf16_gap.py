"""How far the bfloat16 training step's gradients sit from the float32 step's.

At the "pwc" init, one batch of seeded snippets goes through the training
forward in float32 and in bfloat16 (``compute_dtype`` and ``loss_dtype``
both), and each dtype's loss pack and its gradients of two weightings over
every parameter are taken: the photometric weights alone (``PHOTO``) and
the recipe's full weights (``WEIGHTS``).  The figures, each a relative L2
norm over all parameters concatenated (sorted by state-dict name):

* ``gap_port``: the port's bfloat16 gradient against its float32 one;
* ``gap_jax``: the JAX package's, read from a file (below);
* ``cross``: the port's bfloat16 gradient against the JAX package's.

The port may not import JAX, so the JAX side runs in its own process,
``tests/torch_fixtures/bf16_gap_jax.py``, which writes the weights, the
snippets and JAX's packs and gradients to an ``.npz``; this script reads it
and prints one JSON line (with the three parameters whose bfloat16
gradient sits farthest from float32's):

    python tests/torch_fixtures/bf16_gap_jax.py --hw 256 832 --batch 1 --out gap.npz
    python -m unopticalflow_tpu_torch.benchmarks.bf16_gap --npz gap.npz --device cpu

Without ``--npz`` it takes the port's own "pwc" init (``--seed``) and
prints ``gap_port`` alone.  On the card the step runs the kernels
(``chip_smoke.py`` phase 22 holds their gap to the plain versions').
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig, forward
from unopticalflow_tpu_torch.utils.device import resolve_device, set_float32_precision

PHOTO = {"loss_pixel": 0.15, "loss_ssim": 0.85, "loss_flow_smooth": 0.0,
         "loss_flow_consis": 0.0}
WEIGHTS = {"loss_pixel": 0.15, "loss_ssim": 0.85, "loss_flow_smooth": 10.0,
           "loss_flow_consis": 0.01}
WEIGHT_SETS = {"photo": PHOTO, "total": WEIGHTS}
DTYPES = ("float32", "bfloat16")


def snippets(batch: int, h: int, w: int, seed: int = 0, synthetic: bool = False) -> np.ndarray:
    """(batch, 3h, w, 3) float32 snippets in [0, 1]: one random frame seen
    at three small shifts (0, (2, 1), (4, 2) pixels), or with ``synthetic``
    the first ``batch`` of ``data/synthetic.py``'s textured snippets (the
    trainer's synthetic set, as uint8 frames / 255)."""
    if synthetic:
        from unopticalflow_tpu_torch.data.synthetic import SyntheticSnippets

        data = SyntheticSnippets((h, w), batch, seed=seed)
        return np.stack([data[i] for i in range(batch)]).astype(np.float32) / 255.0
    rng = np.random.RandomState(seed)
    base = rng.rand(batch, h + 4, w + 4, 3).astype(np.float32)
    return np.concatenate([base[:, 0:h, 0:w], base[:, 2:h + 2, 1:w + 1],
                           base[:, 4:h + 4, 2:w + 2]], 1)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def step(model: FlowModel, cfg: FlowModelConfig, images: torch.Tensor, **fns):
    """({loss: (B,) float64}, {weight set: flat float64 gradient over every
    parameter, sorted by name}) of one training forward: the gradient of
    ``sum(w[k] * pack[k].mean())`` for each of ``WEIGHT_SETS``, through one
    forward."""
    names, params = zip(*sorted(model.named_parameters()))
    pack = forward(model, cfg, images, **fns)
    grads = {}
    for i, (name, wts) in enumerate(WEIGHT_SETS.items()):
        total = sum(wts[k] * v.mean() for k, v in pack.items())
        g = torch.autograd.grad(total, params, retain_graph=i + 1 < len(WEIGHT_SETS))
        grads[name] = torch.cat([x.double().ravel() for x in g]).cpu().numpy()
    return {k: v.detach().double().cpu().numpy() for k, v in pack.items()}, grads


def port_steps(state: dict, images: np.ndarray, device, **fns) -> dict:
    """{dtype: step(...)} of the port at the weights ``state`` (a state dict
    of numpy arrays), in float32 and in bfloat16."""
    x = torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(device)
    out = {}
    for dtype in DTYPES:
        cfg = FlowModelConfig(compute_dtype=dtype, loss_dtype=dtype)
        model = FlowModel(cfg, device=device)
        model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()},
                              strict=True)
        out[dtype] = step(model, cfg, x, **fns)
        del model
    return out


def gaps(port: dict, jax: dict | None = None) -> dict:
    """The figures of each weight set from ``port_steps``'s result and, when
    given, the JAX package's in the same form: {set: {figure: rel L2}}, plus
    each bfloat16 loss's largest relative distance from JAX's (``pack``)."""
    out = {}
    for name in WEIGHT_SETS:
        row = {"gap_port": rel_l2(port["bfloat16"][1][name], port["float32"][1][name])}
        if jax is not None:
            row["gap_jax"] = rel_l2(jax["bfloat16"][1][name], jax["float32"][1][name])
            row["cross"] = rel_l2(port["bfloat16"][1][name], jax["bfloat16"][1][name])
            row["cross_f32"] = rel_l2(port["float32"][1][name], jax["float32"][1][name])
        out[name] = row
    if jax is not None:
        out["pack"] = {k: float(np.max(np.abs(port["bfloat16"][0][k] - v) / np.abs(v)))
                       for k, v in jax["bfloat16"][0].items()}
    return out


def worst_tensors(state: dict, port: dict, k: int = 3) -> list:
    """The ``k`` parameters whose full-weights bfloat16 gradient sits
    farthest from the float32 one: [name, |bf16 - f32|, |f32|] each."""
    rows, off = [], 0
    bf, f32 = port["bfloat16"][1]["total"], port["float32"][1]["total"]
    for name in sorted(state):
        n = np.asarray(state[name]).size
        a, b = bf[off:off + n], f32[off:off + n]
        rows.append([name, float(np.linalg.norm(a - b)), float(np.linalg.norm(b))])
        off += n
    return sorted(rows, key=lambda r: -r[1])[:k]


def read_npz(path: str):
    """(state dict, snippets, JAX's result in ``port_steps``'s form, or None
    for a file with the weights and snippets alone) of a file
    ``tests/torch_fixtures/bf16_gap_jax.py`` wrote."""
    z = np.load(path)
    state = {k[len("state/"):]: z[k] for k in z.files if k.startswith("state/")}
    if not any(k.startswith("grad/") for k in z.files):
        return state, z["images"], None
    jax = {}
    for dtype in DTYPES:
        pack = {k.rsplit("/", 1)[1]: z[k].astype(np.float64) for k in z.files
                if k.startswith(f"pack/{dtype}/")}
        grads = {name: z[f"grad/{dtype}/{name}"].astype(np.float64) for name in WEIGHT_SETS}
        jax[dtype] = (pack, grads)
    return state, z["images"], jax


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--npz", help="the JAX side's file (tests/torch_fixtures/bf16_gap_jax.py)")
    p.add_argument("--hw", type=int, nargs=2, default=(256, 832),
                   help="snippet size without --npz")
    p.add_argument("--batch", type=int, default=1, help="batch without --npz")
    p.add_argument("--seed", type=int, default=0, help="init and snippets without --npz")
    p.add_argument("--synthetic", action="store_true",
                   help="data/synthetic.py's snippets without --npz (else noise frames)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    set_float32_precision(device, "float32")
    jax = None
    if args.npz:
        state, images, jax = read_npz(args.npz)
    else:
        model = FlowModel(device="cpu", scheme="pwc",
                          generator=torch.Generator().manual_seed(args.seed))
        state = {k: v.numpy() for k, v in model.state_dict().items()}
        images = snippets(args.batch, *args.hw, seed=args.seed, synthetic=args.synthetic)
    port = port_steps(state, images, device)
    b, h3, w = images.shape[:3]
    print(json.dumps({"shape": [b, h3 // 3, w], "device": str(device), **gaps(port, jax),
                      "worst": worst_tensors(state, port)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
