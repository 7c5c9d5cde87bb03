"""The port's gathers (``ops/gather.py``) and gather probes against the JAX
probes, on the CPU, where the dispatchers take the plain versions.

* ``row_gather`` against ``jnp.take_along_axis`` (what the JAX probe checks
  its ``pallas_loop3`` against), bit for bit, in bfloat16 and float32,
  including a ragged R that is no multiple of the TPU kernel's 2048-row
  chunk and indices 0 and N - 1.
* ``lane_gather``/``sublane_gather`` against the JAX probe's own
  ``lane_kernel``/``sublane_kernel`` (``benchmarks/pallas_gather_probe.py``,
  loaded by path), run by ``pl.pallas_call(..., interpret=True)`` with the
  VMEM specs of its ``run``, bit for bit: both sum in x's dtype in the order
  k = 0..63, rounding after every add.
* Each probe's ``main`` in every mode at a small size.

The kernels themselves run only on a card (``tests/test_torch_cuda.py``).
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unopticalflow_tpu_torch.benchmarks import block_gather_probe, gather_probe
from unopticalflow_tpu_torch.ops import gather, gather_cuda
from unopticalflow_tpu_torch.ops.gather import lane_gather, row_gather, sublane_gather

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    # the probes' plain block gathers are 64 small operations each: one
    # thread runs them about 20 times faster than eight on a shared CPU
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_probe():
    path = os.path.join(REPO, "benchmarks", "pallas_gather_probe.py")
    spec = importlib.util.spec_from_file_location("jax_pallas_gather_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bits(a) -> np.ndarray:
    """The raw bits of a torch tensor or JAX array, for bit-for-bit checks."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32).numpy()
        return a.view(np.uint16 if a.dtype == np.int16 else np.uint32)
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _to_jax(t: torch.Tensor):
    """The same values in JAX: bfloat16 moved by its bits, never re-rounded."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,w,c", [(2, 32, 64, 12), (3, 45, 61, 5)],
                         ids=["2x32x64_c12", "ragged_3x45x61_c5"])
def test_row_gather_matches_take_along_axis(b, h, w, c, dtype):
    n, r = (h + 1) * (w + 1), h * w
    rng = np.random.RandomState(h + c)
    img = torch.from_numpy(rng.rand(b, n, c).astype(np.float32)).to(dtype)
    idx_np = rng.randint(0, n, (b, r, 1)).astype(np.int32)
    idx_np[0, 0, 0], idx_np[-1, -1, 0], idx_np[-1, 0, 0] = 0, n - 1, n - 1
    got = row_gather(img, torch.from_numpy(idx_np))
    want = jnp.take_along_axis(_to_jax(img), jnp.asarray(idx_np), axis=1)
    assert got.dtype == dtype and tuple(got.shape) == (b, r, c)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _run_jax_kernel(mod, kernel, x, idx):
    vmem = mod.pltpu.VMEM
    f = mod.pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        in_specs=[mod.pl.BlockSpec(memory_space=vmem), mod.pl.BlockSpec(memory_space=vmem)],
        out_specs=mod.pl.BlockSpec(memory_space=vmem),
        interpret=True,
    )
    return jax.jit(f)(x, idx)


@pytest.mark.parametrize("kind,shape,dtype", [
    ("lane", (16, 128), torch.float32),
    ("lane", (16, 128), torch.bfloat16),
    ("sublane", (8, 256), torch.float32),
], ids=["lane_f32", "lane_bf16", "sublane_f32"])
def test_block_gathers_match_the_jax_probe_kernels(jax_probe, kind, shape, dtype):
    rng = np.random.RandomState(shape[1])
    x = torch.from_numpy(rng.rand(*shape).astype(np.float32) * 1.3).to(dtype)
    span = shape[1] if kind == "lane" else shape[0]
    idx = rng.randint(0, span, shape).astype(np.int32)
    fn, kernel = ((lane_gather, jax_probe.lane_kernel) if kind == "lane"
                  else (sublane_gather, jax_probe.sublane_kernel))
    assert gather.REPS == jax_probe.REPS
    got = fn(x, torch.from_numpy(idx))
    want = _run_jax_kernel(jax_probe, kernel, _to_jax(x), jnp.asarray(idx))
    assert got.dtype == dtype and tuple(got.shape) == shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_block_gathers_wrap_by_floor_modulo():
    """Negative indices wrap as JAX's % and torch.remainder do; float32 sums
    in the order k = 0, 1, ... (numpy's sequential adds)."""
    rng = np.random.RandomState(3)
    x = rng.rand(5, 24).astype(np.float32)
    idx = rng.randint(-30, 30, (5, 24)).astype(np.int32)
    want_l = np.zeros_like(x)
    want_s = np.zeros_like(x)
    rows, cols = np.indices(x.shape)
    for k in range(gather.REPS):
        want_l = want_l + x[rows, (idx + k) % 24]
        want_s = want_s + x[(idx + k) % 5, cols]
    tx, ti = torch.from_numpy(x), torch.from_numpy(idx)
    np.testing.assert_array_equal(lane_gather(tx, ti).numpy(), want_l)
    np.testing.assert_array_equal(sublane_gather(tx, ti).numpy(), want_s)


def test_cpu_tensors_take_the_plain_versions_and_the_kernels_refuse_them(monkeypatch):
    x = torch.rand(8, 16)
    idx = torch.randint(0, 8, (8, 16), dtype=torch.int32)
    img = torch.rand(2, 9, 3)
    ridx = torch.randint(0, 9, (2, 4, 1), dtype=torch.int32)
    before = dict(gather_cuda.launches)
    for name in ("row_gather", "lane_gather", "sublane_gather"):
        with pytest.raises(ValueError, match="CUDA"):
            getattr(gather_cuda, name)(*((img, ridx) if name == "row_gather" else (x, idx)))

    def no_kernel(*a, **k):
        raise AssertionError("a CPU tensor reached a kernel wrapper")

    for name in ("row_gather", "lane_gather", "sublane_gather"):
        monkeypatch.setattr(gather_cuda, name, no_kernel)
    torch.testing.assert_close(row_gather(img, ridx), gather.row_gather_reference(img, ridx),
                               rtol=0, atol=0)
    lane_gather(x, idx)
    sublane_gather(x, idx)
    assert gather_cuda.launches == before


GATHER_MODES = {
    "default": ["taa", "taa_f32", "flat", "taa_pad16", "taa_pad128", "taa_u32x6", "flat_u32",
                "flat_u32_pad8", "flat_u32_2x", "flat_u32_sorted", "flat_u32_4x",
                "flat_u32_8x", "flat_u32_16x", "taa_chunk4", "taa_chunk16", "row_gather"],
    "widths": [f"flat_u32_w{k}" for k in (1, 2, 3, 4, 6, 8, 16)] + ["flat_u8_w12"],
    "layout": ["rm_take", "cm_take", "cm_take_out_t", "rm_take_in_t", "cm_per_ch"],
    "diffwarp": ["rm_fwd", "cm_fwd", "rm_bwd_batched", "cm_bwd", "rm_bwd_flat"],
}
CPU_RUN = ["--device", "cpu", "--iters", "1", "--warmup", "0"]


def _printed(capsys) -> tuple[str, dict]:
    out = capsys.readouterr().out
    return out, json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("mode", sorted(GATHER_MODES))
def test_gather_probe_runs_every_variant(capsys, mode):
    flag = [] if mode == "default" else [f"--{mode}"]
    assert gather_probe.main(["--batch", "1", "--hw", "32", "64", *flag, *CPU_RUN]) == 0
    out, rec = _printed(capsys)
    assert "FAIL" not in out
    assert rec["probe"] == "gather_probe" and rec["mode"] == mode and rec["device"] == "cpu"
    assert list(rec["results"]) == GATHER_MODES[mode]
    assert all(v["ms"] > 0 and v["ns_per_row"] > 0 for v in rec["results"].values())
    for name in GATHER_MODES[mode]:
        assert f"  {name} " in out


def test_block_gather_probe_runs_every_run(capsys):
    assert block_gather_probe.main(CPU_RUN) == 0
    out, rec = _printed(capsys)
    assert rec["probe"] == "block_gather_probe" and rec["reps"] == 64
    assert list(rec["results"]) == ["lane_f32", "lane_bf16", "sublane_f32"]
    assert [v["shape"] for v in rec["results"].values()] == [[4096, 128], [4096, 128],
                                                             [8, 8192]]
    assert all(v["ms"] > 0 for v in rec["results"].values()) and "ns/elem" in out
