"""A configuration file of `benchmark/configs/` as the reference reads it:
the JSON sections as attribute namespaces, and the constants the model
derives from them worked out again here (pyramid levels, strides, anchor
sizes, cell counts), so the reference takes none of them from the program.

A file has a `student` (and, for distillation, a `teacher`) model section
and shared `data`, `solver`, `test` and `kd` sections; `Cfg(raw, "student")`
is the student's view of it.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Tuple


# channels each backbone hands the FPN (0 = a level the FPN skips) and the
# FPN / head width (reference arguments/argument.py:51-71)
BACKBONES = {
    "darknet_tiny_h": dict(feat_channels=(0, 0, 64, 64), out_channel=128),
    "darknet53": dict(feat_channels=(0, 0, 256, 512, 1024), out_channel=256),
}


def _ns(d: dict) -> SimpleNamespace:
    return SimpleNamespace(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in d.items()})


class Model(SimpleNamespace):
    """One model section with its derived constants."""

    @property
    def feat_channels(self) -> Tuple[int, ...]:
        return BACKBONES[self.backbone]["feat_channels"]

    @property
    def out_channel(self) -> int:
        return BACKBONES[self.backbone]["out_channel"]

    @property
    def num_levels(self) -> int:
        n = sum(1 for c in self.feat_channels if c > 0)
        return n + (2 if self.use_higher_levels else 0)

    @property
    def level_strides(self) -> Tuple[int, ...]:
        return tuple(self.anchor_strides[:self.num_levels])

    @property
    def level_sizes(self) -> Tuple[int, ...]:
        return tuple(self.anchor_sizes[:self.num_levels])

    @property
    def num_cells(self) -> int:
        return sum((self.input_res // s) ** 2 for s in self.level_strides)


class Cfg:
    """`model` is the named model section; `data`, `solver`, `test`, `kd`
    are shared."""

    def __init__(self, raw: dict, which: str = "student"):
        m = raw[which]["model"]
        self.model = Model(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in m.items()})
        self.data = _ns(raw["data"])
        self.solver = _ns(raw["solver"])
        self.test = _ns(raw["test"])
        self.kd = _ns(raw["kd"])
        self.n_fg = self.data.n_class - 1
