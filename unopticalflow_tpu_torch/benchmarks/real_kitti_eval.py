"""Real-data KITTI EPE in one command: the accuracy target.

The port's counterpart of ``benchmarks/real_kitti_eval.py``, a thin wrapper
over the port's ``test.py`` (``test_kitti_2012``, ``test_kitti_2015``): KITTI
2012 and/or 2015 training trees and a checkpoint (``.pth`` or the JAX
package's ``.ckpt``) in, the two EPE tables out, parsed, and one JSON line
beside the reference's published targets.  ``--limit N`` evaluates the
first N frames of each (the CPU tests' synthetic trees); leave it unset for
the real numbers.  ``--pallas_corr`` is the JAX tool's TPU A/B switch of its
correlation: the port refuses it (on the card the correlation always runs
the port's kernel).

    python -m unopticalflow_tpu_torch.benchmarks.real_kitti_eval \
        --pretrained_model last.pth --gt_2012_dir /data/kitti_2012/training \
        --gt_2015_dir /data/kitti_2015/training [--precision bfloat16] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import types

from unopticalflow_tpu_torch import test as port_test
from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig
from unopticalflow_tpu_torch.utils.checkpoint import load_pretrained
from unopticalflow_tpu_torch.utils.device import resolve_device, set_float32_precision

# the reference's published training-set EPEs (its README)
REFERENCE_TARGETS = {"kitti_2012": 2.67, "kitti_2015": 7.1}


def parse_epe(result_str: str) -> dict:
    """``eval_flow_avg``'s table (a header row, a value row) as a dict."""
    lines = [ln for ln in result_str.strip().splitlines() if ln.strip()]
    header = [h.strip() for h in lines[0].split(",")]
    return dict(zip(header, (float(v) for v in lines[1].split(","))))


def run_eval(pretrained_model: str | None, gt_2012_dir: str | None, gt_2015_dir: str | None,
             img_hw=(256, 832), limit: int | None = None, precision: str = "float32",
             device="cuda") -> dict:
    """Evaluate a checkpoint on KITTI 2012 and/or 2015; the metrics dict."""
    device = resolve_device(device)
    set_float32_precision(device, precision)
    model = FlowModel(FlowModelConfig(num_scales=3, compute_dtype=precision), device=device)
    if pretrained_model:
        load_pretrained(model, pretrained_model)
        print(f"loaded {pretrained_model}")
    else:
        print("WARNING: no --pretrained_model; evaluating a RANDOM INIT (only meaningful as "
              "a pipeline smoke test)")
    infer = port_test.make_infer(model)
    results: dict = {"img_hw": list(img_hw), "checkpoint": pretrained_model}
    for key, gt_dir, load, evaluate in (
            ("kitti_2012", gt_2012_dir, port_test.load_kitti_2012, port_test.test_kitti_2012),
            ("kitti_2015", gt_2015_dir, port_test.load_kitti_2015, port_test.test_kitti_2015)):
        if not gt_dir:
            continue
        cfg = types.SimpleNamespace(img_hw=tuple(img_hw), gt_2012_dir=gt_2012_dir,
                                    gt_2015_dir=gt_2015_dir, config_file="(real_kitti_eval)",
                                    mode="flow", model_dir=".")
        res = evaluate(cfg, infer, load(cfg, limit), device)
        results[key] = parse_epe(res)
        results[key + "_str"] = res
    return results


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pretrained_model", default=None,
                   help="a .pth or the JAX package's .ckpt")
    p.add_argument("--gt_2012_dir", default=None,
                   help="KITTI 2012 training/ dir (image_2 + flow_occ/noc + calib_cam_to_cam)")
    p.add_argument("--gt_2015_dir", default=None,
                   help="KITTI 2015 training/ dir (image_2 + flow_occ/noc + obj_map)")
    p.add_argument("--img_hw", type=int, nargs=2, default=(256, 832))
    p.add_argument("--limit", type=int, default=None,
                   help="evaluate only the first N frames (smoke tests)")
    p.add_argument("--precision", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--pallas_corr", default=None,
                   help="the JAX tool's TPU correlation switch: refused by the port")
    p.add_argument("--out_json", default=None, help="also write the metrics dict here")
    p.add_argument("--device", default="cuda", help="cuda (raises without a GPU) or cpu")
    args = p.parse_args(argv)
    if args.pallas_corr is not None:
        p.error("--pallas_corr is the JAX tool's TPU A/B switch of its correlation; the port "
                "always runs its CUDA correlation kernel on the card (and the plain version "
                "on the CPU)")
    if not (args.gt_2012_dir or args.gt_2015_dir):
        p.error("need --gt_2012_dir and/or --gt_2015_dir")
    results = run_eval(args.pretrained_model, args.gt_2012_dir, args.gt_2015_dir,
                       img_hw=tuple(args.img_hw), limit=args.limit, precision=args.precision,
                       device=args.device)
    line = {k: results[k]["epe"] for k in ("kitti_2012", "kitti_2015") if k in results}
    line["reference_targets"] = REFERENCE_TARGETS
    print(json.dumps(line))
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
