"""The port's whole serving slice against the JAX package (CPU, 64x128, batch 2).

Same ``init_flow_model(scheme="pwc")`` params on both sides (the default
"torch" init is input-blind to ~4e-6 px, which would make parity vacuous),
same numpy images.  Tolerances: float32 within 1e-4 * (1 + max|flow|);
bfloat16 within 2e-2 * max|flow| (the two frameworks round bf16 at
different places across ~40 layers).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unopticalflow_tpu.models import FlowModelConfig as JaxFlowModelConfig
from unopticalflow_tpu.models import inference_flow as jax_inference_flow
from unopticalflow_tpu.models import init_flow_model
from unopticalflow_tpu.utils.torch_convert import (
    export_torch_checkpoint,
    params_to_torch_state_dict,
)
from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig, inference_flow
from unopticalflow_tpu_torch.utils.checkpoint import load_pretrained
from unopticalflow_tpu_torch.utils.convert import load_jax_params


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    # the suite runs in several workers on one machine's cores, where torch's
    # spinning thread pools (one thread a core in every worker) made the model
    # runs here up to ~70 times slower than alone (a 7 s test took 504 s)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


B, H, W = 2, 64, 128


@pytest.fixture(scope="module")
def params():
    init = jax.jit(init_flow_model, static_argnames="scheme")
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), scheme="pwc"))


@pytest.fixture(scope="module")
def images():
    rng = np.random.RandomState(0)
    return (rng.rand(B, H, W, 3).astype(np.float32),
            rng.rand(B, H, W, 3).astype(np.float32))


def _port_flow(model, images):
    with torch.inference_mode():
        out = inference_flow(model, *(torch.from_numpy(x) for x in images))
    assert out.dtype == torch.float32 and tuple(out.shape) == (B, H, W, 2)
    return out.numpy()


def _jax_flow(params, compute_dtype, images):
    cfg = JaxFlowModelConfig(compute_dtype=compute_dtype)
    fn = jax.jit(lambda p, a, b: jax_inference_flow(p, cfg, a, b))
    return np.asarray(fn(params, *(jnp.asarray(x) for x in images)))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_inference_flow_matches_jax(params, images, compute_dtype):
    model = load_jax_params(
        FlowModel(FlowModelConfig(compute_dtype=compute_dtype), device="cpu"), params
    )
    got = _port_flow(model, images)
    want = _jax_flow(params, compute_dtype, images)
    peak = np.abs(want).max()
    assert peak > 1.0  # the pwc init gives an input-sensitive, non-trivial flow
    tol = 1e-4 * (1 + peak) if compute_dtype == "float32" else 2e-2 * peak
    assert np.abs(got - want).max() <= tol


def test_state_dict_keys_are_the_references(params):
    model = FlowModel(device="cpu")
    state = params_to_torch_state_dict(params)
    assert set(model.state_dict()) == set(state)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()},
                          strict=True)
    assert "pwc_model.predict_flow2.weight" in state
    assert "pwc_model.dc_conv7.weight" in state and "fpyramid.conv12.0.bias" in state


def test_exported_pth_loads_and_gives_the_same_flow(params, images, tmp_path):
    path = str(tmp_path / "model.pth")
    export_torch_checkpoint(path, params, iteration=7)
    model = FlowModel(device="cpu")  # torch-init weights, all to be replaced
    assert load_pretrained(model, path) == 7
    direct = load_jax_params(FlowModel(device="cpu"), params)
    np.testing.assert_array_equal(_port_flow(model, images), _port_flow(direct, images))


def test_flax_checkpoint_is_refused_with_the_way_out(params, images, tmp_path):
    """The JAX package's ``.ckpt`` now loads (the same flow as the params
    moved across directly); a ``.ckpt`` that holds no flow-mode train state
    is refused, naming the layout it expects."""
    from unopticalflow_tpu.utils.checkpoint import save_checkpoint

    path = str(tmp_path / "last.ckpt")
    save_checkpoint(path, 9, params)
    model = FlowModel(device="cpu")
    assert load_pretrained(model, path) == 9
    direct = load_jax_params(FlowModel(device="cpu"), params)
    np.testing.assert_array_equal(_port_flow(model, images), _port_flow(direct, images))
    save_checkpoint(path, 9, {"flow": params})  # a flowposenet tree
    with pytest.raises(ValueError, match="not a flow-mode train state"):
        load_pretrained(FlowModel(device="cpu"), path)
