"""The JAX side of ``unopticalflow_tpu_torch/benchmarks/bf16_gap.py``.

Writes an ``.npz`` with the weights of ``init_flow_model(PRNGKey(seed),
scheme="pwc")`` (or with ``--port-init`` the port's own "pwc" init) as the
port's state dict (``state/<name>``), the seeded
snippets (``bf16_gap.snippets``: noise frames, or with ``--synthetic`` the
trainer's synthetic set; ``images``), and for float32 and bfloat16
(``compute_dtype`` and ``loss_dtype`` both; the XLA loss path,
``use_pallas_photo=False``) the loss pack (``pack/<dtype>/<loss>``) and
the flat gradients over every parameter, sorted by state-dict name, of
the photometric weights and of the full weights
(``grad/<dtype>/photo``, ``grad/<dtype>/total``): one jitted forward and
one ``jax.vjp`` a dtype, its two cotangents batched by ``jax.vmap``.

    python tests/torch_fixtures/bf16_gap_jax.py --hw 256 832 --batch 1 --out gap.npz

It needs JAX on the CPU (``JAX_PLATFORMS=cpu``).
"""

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from unopticalflow_tpu_torch.benchmarks.bf16_gap import (  # noqa: E402
    DTYPES,
    WEIGHT_SETS,
    snippets,
)


def jax_steps(params, images, dtypes=DTYPES) -> dict:
    """{dtype: ({loss: (B,) float64}, {weight set: flat float64 gradient})}
    of the JAX package's training forward, in ``bf16_gap.port_steps``'s
    form.  ``params``: ``init_flow_model``'s tree."""
    import jax
    import jax.numpy as jnp

    from unopticalflow_tpu.models import FlowModelConfig, forward
    from unopticalflow_tpu.utils.torch_convert import params_to_torch_state_dict

    b = images.shape[0]
    keys = sorted(next(iter(WEIGHT_SETS.values())))
    wts = jnp.asarray([[w[k] / b for k in keys] for w in WEIGHT_SETS.values()], jnp.float32)
    out = {}
    for dtype in dtypes:
        cfg = FlowModelConfig(num_scales=3, compute_dtype=dtype, loss_dtype=dtype,
                              use_pallas_photo=False)

        def fn(p, x, cfg=cfg):
            pack, vjp = jax.vjp(lambda q: forward(q, cfg, x), p)

            def grad(w):
                return vjp({k: jnp.broadcast_to(w[i], pack[k].shape).astype(pack[k].dtype)
                            for i, k in enumerate(keys)})[0]

            return pack, jax.vmap(grad)(wts)

        pack, grads = jax.jit(fn)(params, jnp.asarray(images))
        grads = jax.tree.map(np.asarray, grads)
        flat = {}
        for i, name in enumerate(WEIGHT_SETS):
            sd = params_to_torch_state_dict(jax.tree.map(lambda g, i=i: g[i], grads))
            flat[name] = np.concatenate([np.ravel(sd[k]).astype(np.float64) for k in sorted(sd)])
        out[dtype] = ({k: np.asarray(v, np.float64) for k, v in pack.items()}, flat)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--hw", type=int, nargs=2, default=(256, 832))
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", action="store_true",
                   help="data/synthetic.py's snippets (else noise frames)")
    p.add_argument("--port-init", action="store_true",
                   help="the port's own \"pwc\" init from --seed (the weights of "
                        "chip_smoke.py phase 22) in place of init_flow_model's")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from unopticalflow_tpu.models import init_flow_model
    from unopticalflow_tpu.utils.torch_convert import params_to_torch_state_dict

    if args.port_init:
        import torch

        from unopticalflow_tpu.utils.torch_convert import torch_state_dict_to_params
        from unopticalflow_tpu_torch.models import FlowModel

        model = FlowModel(device="cpu", scheme="pwc",
                          generator=torch.Generator().manual_seed(args.seed))
        params = torch_state_dict_to_params({k: v.numpy() for k, v in model.state_dict().items()})
    else:
        init = jax.jit(init_flow_model, static_argnames="scheme")
        params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(args.seed), scheme="pwc"))
    images = snippets(args.batch, *args.hw, seed=args.seed, synthetic=args.synthetic)
    res = jax_steps(params, images)
    arrays = {"images": images}
    arrays.update({f"state/{k}": v for k, v in params_to_torch_state_dict(params).items()})
    for dtype, (pack, grads) in res.items():
        arrays.update({f"pack/{dtype}/{k}": v for k, v in pack.items()})
        arrays.update({f"grad/{dtype}/{k}": v for k, v in grads.items()})
    np.savez(args.out, **arrays)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
