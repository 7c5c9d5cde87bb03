"""The port's sharded occlusion ablation (``use_occlusion_weights=False``)
against the JAX package's unsharded ``forward`` and the port's (CPU).

``make_spatial_forward`` of a ``FlowModel`` with the ablation's config: the
plain row-shard pack (``photometric_pack_rows_reference(use_weights=False)``:
the weights are the warps' validity) and the plain smoothness and
consistency sums, whatever ``use_pallas_reg`` says, as the unsharded forward
takes them.  Shapes, weights and tolerances: ``tests/torch_fixtures/
spatial_forms.py``.
"""

import pytest

from tests.torch_fixtures.spatial_forms import (FORMS, MESHES, check, few_threads,  # noqa: F401
                                                jax_reference, port_run)

FORM = FORMS["ablation"]


@pytest.fixture(scope="module")
def ref():
    return jax_reference(FORM)


@pytest.fixture(scope="module")
def dense(ref):
    """The port's unsharded pack and gradients by height."""
    return {h: port_run(FORM, ref["params"], *ref[h][:2]) for h in FORM.heights()}


@pytest.mark.parametrize("reg", [False, True], ids=["reg_off", "reg_on"])
@pytest.mark.parametrize("mesh_id", FORM.meshes())
def test_sharded_ablation_matches_jax_and_unsharded(ref, dense, mesh_id, reg):
    h = MESHES[mesh_id][2]
    images, ks, jax_pack, jax_grads = ref[h]
    got = port_run(FORM, ref["params"], images, ks, reg=reg, mesh_id=mesh_id)
    check(got, (jax_pack, jax_grads), dense[h])
