"""The port's sharded 2-frame flow + pose forward (``forward_flowpose_pair``)
against the JAX package's unsharded one and the port's (CPU).

``make_spatial_forward(FlowPoseModel, frames=2)``: the 2-frame flow losses
as ``tests/test_torch_spatial_pair.py`` holds them, the pose net over the
pairs [(1, 2); (2, 1)] on the row-shards (``spatial.pose_rows``), and
``loss_pose_epipolar`` as the ratio of the shards' added epipolar sums.  The
pose net's gradients are held by the rule of ``spatial_forms.check`` (its
docstring says why).  Shapes, weights and tolerances:
``tests/torch_fixtures/spatial_forms.py``; H 192 at n = 3 too.
"""

import numpy as np
import pytest

from tests.torch_fixtures.spatial_forms import (FORMS, MESHES, check, few_threads,  # noqa: F401
                                                jax_reference, port_run)

FORM = FORMS["flowpose_pair"]


@pytest.fixture(scope="module")
def ref():
    return jax_reference(FORM)


@pytest.fixture(scope="module")
def dense(ref):
    """The port's unsharded pack and gradients by height, and its gradients
    on the snippets moved by one float32 ulp."""
    return {h: (port_run(FORM, ref["params"], *ref[h][:2]),
                port_run(FORM, ref["params"], np.nextafter(ref[h][0], np.float32(2)),
                         ref[h][1])[1])
            for h in FORM.heights()}


@pytest.mark.parametrize("mesh_id", FORM.meshes())
def test_sharded_flowpose_pair_matches_jax_and_unsharded(ref, dense, mesh_id):
    h = MESHES[mesh_id][2]
    images, ks, jax_pack, jax_grads = ref[h]
    got = port_run(FORM, ref["params"], images, ks, mesh_id=mesh_id)
    check(got, (jax_pack, jax_grads), *dense[h])
