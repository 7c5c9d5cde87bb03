"""Loss logging of the trainer, and the demo's flow image.

The port's copy of ``Visualizer`` from ``unopticalflow_tpu/utils/visualizer.py``:
it accumulates log packs (the interleaved evaluation's result strings),
pickles them to ``log.pkl``, and prints the four flow losses in the
reference trainer's ``iter: N, loss_pixel: ...`` format.
``VisualizerDebug.save_flow_img`` writes the colour-wheel PNG of a flow,
which ``test.py --task demo`` saves.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from unopticalflow_tpu_torch.evaluation.flowlib import flow_to_image
from unopticalflow_tpu_torch.utils import imageio

_LOSSES = ("loss_pixel", "loss_ssim", "loss_flow_smooth", "loss_flow_consis")


class Visualizer:
    def __init__(self, loss_weights_dict, dump_dir: str | None = None):
        self.loss_weights_dict = loss_weights_dict
        self.dump_dir = dump_dir
        self.log_list = []

    def add_log_pack(self, log_pack):
        self.log_list.append(log_pack)

    def dump_log(self, fname: str | None = None):
        fname = fname or self.dump_dir
        with open(fname, "wb") as f:
            pickle.dump(self.log_list, f)

    def print_loss(self, loss_pack, iter_=None):
        vals = {k: float(np.mean(np.asarray(v))) for k, v in loss_pack.items()}
        line = (
            "iter: {it}, loss_pixel: {loss_pixel:.6f}, loss_ssim: {loss_ssim:.6f}, "
            "loss_flow_smooth: {loss_flow_smooth:.6f}, "
            "loss_flow_consis: {loss_flow_consis:.6f}".format(
                it=iter_, **{k: vals.get(k, float("nan")) for k in _LOSSES})
        )
        # other values (e.g. snippets_per_sec) follow the reference's four,
        # so the log prefix stays grep-stable
        for k in sorted(vals):
            if k not in _LOSSES:
                line += f", {k}: {vals[k]:.6f}"
        print(line)


class VisualizerDebug:
    """The JAX package's debug-image dumper, as far as the demo uses it."""

    def __init__(self, dump_dir: str | None = None):
        self.dump_dir = dump_dir
        if dump_dir:
            os.makedirs(dump_dir, exist_ok=True)

    def save_flow_img(self, flow, name: str) -> str:
        """``<dump_dir>/<name>_flow.png``: the colour wheel of an (H, W, 2) flow."""
        path = os.path.join(self.dump_dir, name + "_flow.png")
        imageio.imwrite(path, flow_to_image(np.asarray(flow)))
        return path
