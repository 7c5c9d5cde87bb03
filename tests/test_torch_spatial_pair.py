"""The port's sharded 2-frame forward (``forward_pair``) against the JAX
package's unsharded one and the port's (CPU).

``make_spatial_forward(FlowModel, frames=2)``: the encoder at 2B with the
source and target features swapped per half, and per loss scale and shard
the whole target map warped by the shard's flow, ``back`` (the swapped
whole-map flow warped by it) and the soft forward-backward weights on a
slab with one halo row each side (SSIM's window).  Shapes, weights and
tolerances: ``tests/torch_fixtures/spatial_forms.py``; H 192 at n = 3 too.
"""

import pytest

from tests.torch_fixtures.spatial_forms import (FORMS, MESHES, check, few_threads,  # noqa: F401
                                                jax_reference, port_run)

FORM = FORMS["pair"]


@pytest.fixture(scope="module")
def ref():
    return jax_reference(FORM)


@pytest.fixture(scope="module")
def dense(ref):
    """The port's unsharded pack and gradients by height."""
    return {h: port_run(FORM, ref["params"], *ref[h][:2]) for h in FORM.heights()}


@pytest.mark.parametrize("mesh_id", FORM.meshes())
def test_sharded_pair_matches_jax_and_unsharded(ref, dense, mesh_id):
    h = MESHES[mesh_id][2]
    images, ks, jax_pack, jax_grads = ref[h]
    got = port_run(FORM, ref["params"], images, ks, mesh_id=mesh_id)
    check(got, (jax_pack, jax_grads), dense[h])
