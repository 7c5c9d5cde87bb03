"""The port's sharded flow + pose forward (``forward_flowpose``), its pose
net over row-shards and its epipolar sums, against the JAX package's
unsharded forward and the port's (CPU).

``make_spatial_forward(FlowPoseModel)``: the 3-frame flow losses as
``tests/test_torch_spatial_train.py`` holds them (with ``use_pallas_reg``
off and on), the pose net over the pairs [(center, prev); (center, next)] on
the row-shards (``spatial.pose_rows``), and ``loss_pose_epipolar`` as the
ratio of the shards' added epipolar sums.  The pose net's gradients are held
by the rule of ``spatial_forms.check`` (its docstring says why).  Shapes,
weights and tolerances: ``tests/torch_fixtures/spatial_forms.py``.

``pose_rows`` is also held alone to the whole-map ``PoseNet``, pose and
every weight's gradient, where its seventh stride-2 conv meets shards that
start on odd rows (H = n * 64: level 6 is one row a shard) or a map of odd
height, within rtol 1e-5 / atol 1e-7 (``tests/test_torch_flowpose.py``'s
pose tolerance) and 1e-5 relative L2 a tensor; and ``epipolar_sums`` of row
slabs, added up, to ``epipolar_loss`` within rtol 1e-6.
"""

import numpy as np
import pytest
import torch

from tests.torch_fixtures.spatial_forms import (FORMS, MESHES, check, few_threads,  # noqa: F401
                                                jax_reference, port_run, rel_l2)
from unopticalflow_tpu_torch.models import FlowPoseModel, FlowModelConfig
from unopticalflow_tpu_torch.models.flowpose_model import (epipolar_loss, epipolar_ratio,
                                                           epipolar_sums)
from unopticalflow_tpu_torch.ops.geometry import fundamental_from_pose
from unopticalflow_tpu_torch.parallel.spatial import pose_rows

FORM = FORMS["flowpose"]


@pytest.fixture(scope="module")
def ref():
    return jax_reference(FORM)


@pytest.fixture(scope="module")
def dense(ref):
    """The port's unsharded pack and gradients by (height, use_pallas_reg),
    and its gradients on the snippets moved by one float32 ulp."""
    return {(h, reg): (port_run(FORM, ref["params"], *ref[h][:2], reg=reg),
                       port_run(FORM, ref["params"], np.nextafter(ref[h][0], np.float32(2)),
                                ref[h][1], reg=reg)[1])
            for h in FORM.heights() for reg in (False, True)}


@pytest.mark.parametrize("reg", [False, True], ids=["reg_off", "reg_on"])
@pytest.mark.parametrize("mesh_id", FORM.meshes())
def test_sharded_flowpose_matches_jax_and_unsharded(ref, dense, mesh_id, reg):
    h = MESHES[mesh_id][2]
    images, ks, jax_pack, jax_grads = ref[h]
    got = port_run(FORM, ref["params"], images, ks, reg=reg, mesh_id=mesh_id)
    check(got, (jax_pack, jax_grads), *dense[h, reg])


@pytest.mark.parametrize("h,n", [(128, 1), (128, 2), (192, 1), (192, 3), (256, 4), (384, 2)])
def test_pose_net_on_row_shards_matches_the_whole_map(h, n):
    """Level 6 holds h / 64 rows: one a shard at (128, 2), (192, 3) and
    (256, 4), whose seventh conv joins shards; three at (192, 1), an odd map;
    three a shard at (384, 2), joined into one of six."""
    model = FlowPoseModel(FlowModelConfig(), device="cpu", scheme="pwc",
                          generator=torch.Generator().manual_seed(h + n))
    rng = np.random.RandomState(h + n)
    first, second = (torch.from_numpy(rng.rand(4, 3, h, 96).astype(np.float32))
                     for _ in range(2))
    cot = torch.from_numpy(rng.randn(4, 6).astype(np.float32))

    def grads(pose):
        model.zero_grad()
        (pose * cot).sum().backward()
        return {k: p.grad.clone() for k, p in model.pose.named_parameters()}

    want = model.pose(first, second)
    g_want = grads(want)
    got = pose_rows(model.pose, list(torch.chunk(first, n, 2)), list(torch.chunk(second, n, 2)))
    g_got = grads(got)
    assert got.shape == (4, 6) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=1e-5, atol=1e-7)
    for k, g in g_want.items():
        assert float(g.abs().max()) > 0, k
        assert rel_l2(g_got[k].numpy(), g.numpy()) < 1e-5, k


@pytest.mark.parametrize("n", [1, 2, 4])
def test_epipolar_sums_over_row_slabs_add_up_to_the_loss(n):
    rng = np.random.RandomState(n)
    h, w = 32, 24
    flow = torch.from_numpy(rng.uniform(-3, 3, (4, 2, h, w)).astype(np.float32))
    weight = torch.from_numpy(rng.rand(4, 1, h, w).astype(np.float32))
    pose = torch.from_numpy(rng.uniform(-0.1, 0.1, (4, 6)).astype(np.float32))
    k = np.tile(np.array([[30.0, 0, 12], [0, 30, 16], [0, 0, 1]], np.float32), (4, 1, 1))
    k, k_inv = torch.from_numpy(k), torch.from_numpy(np.linalg.inv(k).astype(np.float32))
    want = epipolar_loss(flow, weight, pose, k, k_inv)
    fund = fundamental_from_pose(pose, k, k_inv)
    hs = h // n
    sums = [epipolar_sums(flow[:, :, r:r + hs], weight[:, :, r:r + hs], fund, row0=r)
            for r in range(0, h, hs)]
    got = epipolar_ratio(sum(a for a, _ in sums), sum(c for _, c in sums))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
    # a shard's rows sit at their rows in the frame: at row 0 they would not
    if n > 1:
        wrong = [epipolar_sums(flow[:, :, r:r + hs], weight[:, :, r:r + hs], fund)
                 for r in range(0, h, hs)]
        assert not np.allclose(epipolar_ratio(sum(a for a, _ in wrong),
                                              sum(c for _, c in wrong)).numpy(), want.numpy())
