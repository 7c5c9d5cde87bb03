"""The port's bfloat16 training step against the JAX package's (CPU, batch 2,
64x64).

The same ``init_flow_model(PRNGKey(0), scheme="pwc")`` weights on both
sides (``params_to_torch_state_dict``), the same seeded snippets
(``benchmarks/bf16_gap.py::snippets``, ``tests/test_torch_train.py``'s).
Each package runs its step with ``compute_dtype = loss_dtype`` float32 and
bfloat16 (JAX on its XLA loss path, the port on its plain versions of the
kernels) and takes the loss pack and the gradients of the photometric
weights and of the full weights over every parameter
(``tests/torch_fixtures/bf16_gap_jax.py::jax_steps``,
``bf16_gap.port_steps``).  Held, each gradient figure a relative L2 norm
over all parameters concatenated:

* the bfloat16 packs within 2e-2 of JAX's bfloat16 packs (the JAX package's
  own bfloat16 tolerance, ``bench.py``'s and ``PALLAS_VALIDATE.json``'s);
* ``gap_port`` (port bfloat16 against port float32) at most 2 x ``gap_jax``
  (JAX bfloat16 against JAX float32) + 1e-3, for both weightings;
* ``cross`` (port bfloat16 against JAX bfloat16) at most 2 x ``gap_jax`` +
  1e-3: bfloat16 rounds each package's own way, so the two bfloat16 steps
  may sit as far apart as either sits from float32, and no farther.
"""

import json

import numpy as np
import pytest
import torch

import jax

from tests.torch_fixtures.bf16_gap_jax import jax_steps
from unopticalflow_tpu.models import init_flow_model
from unopticalflow_tpu.utils.torch_convert import params_to_torch_state_dict
from unopticalflow_tpu_torch.benchmarks import bf16_gap

B, H, W = 2, 64, 64
PACK_RTOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    # several xdist workers share the machine's cores (tests/test_torch_train.py)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    init = jax.jit(init_flow_model, static_argnames="scheme")
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), scheme="pwc"))


@pytest.fixture(scope="module")
def images():
    return bf16_gap.snippets(B, H, W, seed=0)


@pytest.fixture(scope="module")
def jax_res(params, images):
    return jax_steps(params, images)


@pytest.fixture(scope="module")
def port_res(params, images):
    return bf16_gap.port_steps(params_to_torch_state_dict(params), images, "cpu")


@pytest.fixture(scope="module")
def figures(port_res, jax_res):
    figs = bf16_gap.gaps(port_res, jax_res)
    print("bf16 gap at 64x64, batch 2: " + json.dumps(figs))
    return figs


def test_bf16_pack_matches_jax(port_res, jax_res, figures):
    for dtype, rtol in (("bfloat16", PACK_RTOL), ("float32", 1e-4)):
        got, want = port_res[dtype][0], jax_res[dtype][0]
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].shape == (B,) and np.isfinite(got[k]).all(), (dtype, k)
            np.testing.assert_allclose(got[k], v, rtol=rtol, err_msg=f"{dtype} {k}")
    assert max(figures["pack"].values()) <= PACK_RTOL


@pytest.mark.parametrize("weights", sorted(bf16_gap.WEIGHT_SETS))
def test_bf16_gradient_gap_no_wider_than_jax(weights, port_res, jax_res, figures):
    fig = figures[weights]
    print(f"{weights}: gap_jax {fig['gap_jax']:.4e}, gap_port {fig['gap_port']:.4e}, "
          f"cross {fig['cross']:.4e} (float32 cross {fig['cross_f32']:.4e})")
    for dtype in bf16_gap.DTYPES:
        g = port_res[dtype][1][weights]
        assert g.shape == jax_res[dtype][1][weights].shape and np.isfinite(g).all()
        assert np.abs(g).max() > 0
    limit = 2 * fig["gap_jax"] + 1e-3
    assert fig["gap_port"] <= limit, fig
    assert fig["cross"] <= limit, fig
    # float32 against float32 stays far inside the bfloat16 gaps
    assert fig["cross_f32"] <= 0.25 * fig["gap_jax"], fig


def test_bf16_gap_script_reads_the_jax_file(tmp_path, capsys, params, images, jax_res,
                                            figures):
    """``bf16_gap.main`` on the file ``bf16_gap_jax.py`` writes gives the
    figures above."""
    arrays = {"images": images}
    arrays.update({f"state/{k}": v for k, v in params_to_torch_state_dict(params).items()})
    for dtype, (pack, grads) in jax_res.items():
        arrays.update({f"pack/{dtype}/{k}": v for k, v in pack.items()})
        arrays.update({f"grad/{dtype}/{k}": v for k, v in grads.items()})
    path = str(tmp_path / "gap.npz")
    np.savez(path, **arrays)
    assert bf16_gap.main(["--npz", path, "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["shape"] == [B, H, W]
    for name in bf16_gap.WEIGHT_SETS:
        for key, value in figures[name].items():
            assert out[name][key] == pytest.approx(value, rel=1e-6), (name, key)
    assert out["pack"] == pytest.approx(figures["pack"], rel=1e-6)
