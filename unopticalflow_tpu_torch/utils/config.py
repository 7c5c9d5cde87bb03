"""YAML + CLI config of the port's entry points.

The port's copy of ``unopticalflow_tpu/utils/config.py``, with the reference
trainer's semantics: the YAML file is loaded flat, ``img_hw`` becomes a
tuple, the argparse attributes are copied *over* the YAML dict (the command
line wins), and the merged dict becomes an attribute object.  ``yaml`` is
imported where a file is read, so the entry points import on a machine
without pyyaml.
"""

from __future__ import annotations


class Config:
    """Flat attribute bag; ``to_dict`` for the trainer's ``config.pkl``."""

    def __init__(self, d: dict | None = None):
        for k, v in (d or {}).items():
            setattr(self, k, v)

    def to_dict(self) -> dict:
        return {k: v for k, v in vars(self).items() if not k.startswith("__")}

    def __repr__(self):
        return f"Config({self.to_dict()!r})"


def load_yaml_config(path: str) -> dict:
    import yaml

    with open(path, "r") as f:
        cfg = yaml.safe_load(f)
    if "img_hw" in cfg:
        cfg["img_hw"] = (int(cfg["img_hw"][0]), int(cfg["img_hw"][1]))
    return cfg


def merge_cli_args(cfg: dict, args) -> Config:
    """Copy the argparse attributes over the YAML dict."""
    for attr in vars(args):
        cfg[attr] = getattr(args, attr)
    return Config(cfg)
