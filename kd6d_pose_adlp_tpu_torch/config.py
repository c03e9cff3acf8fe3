"""Typed configuration, a verbatim copy of `kd6d_pose_adlp_tpu/config.py`.

The PyTorch port keeps its own copy so that it imports nothing of the JAX
package; the two files must stay field-for-field identical (the port's
tests build one config of each and compare them).

Mirrors the reference's two-stage config (YAML + argparse overrides + derived
constants): reference `arguments/argument.py:24-104`, `arguments/argument_kd.py:15-106`,
`configs/ape.yaml`. Instead of a raw nested dict we use frozen dataclasses so
every field is hashable and can parameterize `jax.jit` as a static argument.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Backbone-derived constants (reference arguments/argument.py:51-71)
# ---------------------------------------------------------------------------
# feat_channels: channel count of each backbone pyramid output fed to the FPN
# (zeros mark skipped levels). out_channel: FPN/head width.
_BACKBONE_SPECS: Dict[str, Dict] = {
    "darknet_tiny": dict(feat_channels=(0, 0, 128, 128), out_channel=256, val_freq=500),
    "darknet_tiny_h": dict(feat_channels=(0, 0, 64, 64), out_channel=128, val_freq=500),
    "darknet53": dict(feat_channels=(0, 0, 256, 512, 1024), out_channel=256, val_freq=2000),
    # TPU experiments (models/darknet.py: lane-padded widths / s2d stem);
    # pyramid channels match darknet_tiny_h so FPN/head are identical
    "darknet_tiny_h_wide": dict(feat_channels=(0, 0, 64, 64), out_channel=128, val_freq=500),
    "darknet_tiny_h_s2d": dict(feat_channels=(0, 0, 64, 64), out_channel=128, val_freq=500),
}

# LINEMOD defaults (reference configs/ape.yaml)
_LINEMOD_DIAMETERS = (
    104.26, 250.85, 167.49, 177.43, 204.83, 154.63, 129.85, 264.12,
    110.83, 164.65, 178.35, 145.61, 279.04, 287.24, 213.25,
)
_LINEMOD_INTERNAL_K = (572.4114, 0.0, 325.2611, 0.0, 573.57043, 242.04899, 0.0, 0.0, 1.0)
# Symmetry spec: class id -> flat list of (axis, mod-degrees) pairs
# (reference configs/ape.yaml:12-15).
_LINEMOD_SYMMETRY: Tuple[Tuple[int, Tuple], ...] = (
    (9, ("X", 180, "Y", 180, "Z", 180)),
    (10, ("Z", 180)),
)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset paths & geometry (reference configs/ape.yaml DATASETS/INPUT)."""
    train_list: str = ""
    valid_list: str = ""
    test_list: str = ""
    mesh_dir: str = ""
    bbox_file: str = ""
    n_class: int = 16  # 15 foreground + background
    mesh_diameters: Tuple[float, ...] = _LINEMOD_DIAMETERS
    symmetry_types: Tuple[Tuple[int, Tuple], ...] = _LINEMOD_SYMMETRY
    internal_width: int = 640
    internal_height: int = 480
    internal_K: Tuple[float, ...] = _LINEMOD_INTERNAL_K
    pixel_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    pixel_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    size_divisible: int = 32
    # single-warp host pipeline: compose the internal-frame and DZI affines
    # into ONE raw->crop warp and run pixel augs on the 256² crop instead of
    # the 640x480 frame (~3x less pixel work per sample). Opt-in because the
    # augmentation domain changes (see data/pipeline.py `sample`, fast path).
    fast_pipeline: bool = False

    @property
    def n_fg(self) -> int:
        return self.n_class - 1

    def internal_K_np(self) -> np.ndarray:
        return np.asarray(self.internal_K, dtype=np.float32).reshape(3, 3)

    def symmetry_dict(self) -> Dict[int, Tuple]:
        return {cid: spec for cid, spec in self.symmetry_types}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model assembly (reference arguments/argument.py:51-76, models/model.py:455-489)."""
    backbone: str = "darknet_tiny_h"
    anchor_sizes: Tuple[int, ...] = (32, 64, 128, 256, 512)
    anchor_strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    n_conv: int = 4
    prior: float = 0.01
    use_higher_levels: bool = True
    input_res: int = 256  # DZI crop size (reference libs/dzi_libs.py:12)
    # compute dtype for conv towers ("float32" | "bfloat16"); params stay f32
    compute_dtype: str = "float32"
    # BN folded into conv weights (inference/frozen-teacher form; params
    # must come from utils/fold_bn.fold_batchnorm — never train with this)
    bn_folded: bool = False
    # rematerialize the student forward during backward (jax.checkpoint):
    # ~1/3 more forward FLOPs for near-zero stored activations — lifts the
    # trainable batch size ceiling on a 16 GB v5e (identical gradients;
    # tests/test_train_e2e.py pins equality)
    remat: bool = False
    # int8 post-training quantization (inference-only, requires bn_folded):
    # "" = off, "calibrate" = float forward that records per-conv input
    # ranges, "quant" = int8 convs from the 'quant' collection built by
    # utils/quant.quantize_variables (v5e MXU int8 peak is 2x bf16)
    quant_mode: str = ""
    # ZebraPose-style dense binary-code head (BASELINE.json configs[5],
    # stretch): 0 = off (the reference's 8-corner keypoint head only);
    # >0 adds a per-cell (code_bits + 2)-channel-per-class output on the
    # pose tower regressing the hierarchical surface code + the 2D offset
    # of the corresponded surface point (ops/binary_code, engine/zebra)
    code_bits: int = 0

    @property
    def feat_channels(self) -> Tuple[int, ...]:
        return tuple(_BACKBONE_SPECS[self.backbone]["feat_channels"])

    @property
    def out_channel(self) -> int:
        return int(_BACKBONE_SPECS[self.backbone]["out_channel"])

    @property
    def num_levels(self) -> int:
        """FPN pyramid levels fed to the head: non-zero backbone levels (+2 for P6/P7)."""
        n = sum(1 for c in self.feat_channels if c > 0)
        return n + (2 if self.use_higher_levels else 0)

    @property
    def level_strides(self) -> Tuple[int, ...]:
        return tuple(self.anchor_strides[: self.num_levels])

    @property
    def level_sizes(self) -> Tuple[int, ...]:
        return tuple(self.anchor_sizes[: self.num_levels])

    @property
    def grid_sizes(self) -> Tuple[int, ...]:
        """Feature-map side length per level at `input_res`. The coarsest
        stride must still produce a >=1 cell grid (stride-2 convs round up,
        so input_res < max stride would desynchronize from the anchor table)."""
        assert self.input_res >= self.level_strides[-1], (
            f"input_res {self.input_res} < coarsest stride {self.level_strides[-1]}")
        return tuple(self.input_res // s for s in self.level_strides)

    @property
    def num_cells(self) -> int:
        """Total anchors/cells per image (1 anchor per cell)."""
        return sum(g * g for g in self.grid_sizes)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Optimization & loss hyperparameters (reference configs/ape.yaml SOLVER +
    arguments/argument.py:78-98, libs/train_libs.py:117-120)."""
    ims_per_batch: int = 16
    base_lr: float = 1e-3
    max_iter: int = 10000
    val_freq: int = 500
    weight_decay: float = 1e-4
    grad_clip: float = 1.0
    loss_weight_cls: float = 0.1
    loss_weight_reg: float = 1.0
    loss_reg_type: str = "3D"  # '3D' object-space | '2D' image-space
    positive_type: str = "SSC"
    positive_num: int = 10
    positive_lambda: float = 1.0
    regression_type: str = "POINT"
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    top_k: int = 9
    # Augmentations (reference configs/ape.yaml:36-44)
    aug_shift: float = 0.05
    aug_scale: float = 0.05
    aug_rotation: float = 10.0
    aug_color_h: float = 0.0
    aug_color_s: float = 0.0
    aug_color_v: float = 0.0
    aug_sharpen: float = 0.0
    aug_smooth: float = 0.0
    aug_noise: float = 0.0
    aug_occlusion: float = 0.0
    aug_grayscalize: bool = False
    aug_background_dir: Optional[str] = None
    # fixed-shape caps (TPU-native; reference uses dynamic shapes)
    max_objs: int = 8       # max object instances per image
    max_pos: int = 64       # max SSC positive cells per image (sum nk <= ~40)
    seed: int = 0
    # dense binary-code losses (engine/zebra; only read when
    # model.code_bits > 0): BCE on the surface code + SmoothL1 on the
    # corresponded point's 2D offset, per positive cell
    loss_weight_code: float = 1.0
    loss_weight_code_off: float = 1.0


@dataclasses.dataclass(frozen=True)
class TestConfig:
    ims_per_batch: int = 8
    confidence_th: float = 0.1  # reference configs/ape.yaml:48
    max_votes: int = 64         # fixed-shape cap for voted cells per image/class
    ransac_iters: int = 128     # RANSAC-EPnP hypotheses (on-device)
    ransac_reproj_err: float = 5.0  # px, reference postprocess/postprocess.py:190
    lhm_iters: int = 10         # LHM object-space refinement after RANSAC
    # (0 = off). The PnP noise study (scripts/pnp_noise_study.py) shows LHM
    # halves p90 rotation error at >=2px vote noise; the reference ships the
    # same refiner but leaves it disabled (postprocess/postprocess.py:180-184)


@dataclasses.dataclass(frozen=True)
class KDConfig:
    """Distillation config (reference arguments/argument_kd.py:37-49)."""
    weight: float = 5.0
    level: str = "pred"
    gtype: str = "sinkhorn"  # l1|l2|sinkhorn|gaussian|laplacian|energy
    glevel: str = "point"
    p: float = 2.0
    blur: float = 0.001
    gn_d: int = 2
    weighted_ot: bool = True
    wot_detach: bool = False
    scaling: float = 0.5
    reach: Optional[float] = 0.5
    max_teacher_cells: int = 64  # fixed-shape cap for teacher voted cells
    # The JAX package's switch between its two routes to the same Sinkhorn
    # potentials (the Pallas kernel or the XLA loop). The port has no XLA
    # route: with gtype "sinkhorn" the potentials always come from K1's
    # wrapper (ops/sinkhorn_fused.solve_potentials), the CUDA kernel on a
    # CUDA tensor and its plain version on a CPU tensor, whatever this
    # says. Kept so the two configs stay field-for-field identical.
    use_pallas: bool = False
    # which class channel the teacher votes: "gt" gathers the image's GT
    # class (identical to the reference's first-candidate label on
    # single-object LINEMOD scenes and cheaper); "pred" votes the teacher's
    # own best-scoring (anchor, class) pair — the reference
    # postprocess/postprocess_kd.py semantics, REQUIRED for multi-class KD
    teacher_class: str = "gt"


@dataclasses.dataclass(frozen=True)
class Config:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    test: TestConfig = dataclasses.field(default_factory=TestConfig)
    kd: KDConfig = dataclasses.field(default_factory=KDConfig)
    working_dir: str = "./outputs/"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True, default=str)


def _sym_to_tuple(sym: Dict) -> Tuple[Tuple[int, Tuple], ...]:
    out = []
    for key, spec in (sym or {}).items():
        cid = int(str(key).replace("cls_", ""))
        out.append((cid, tuple(spec)))
    return tuple(sorted(out))


def load_yaml_config(path: str, backbone: Optional[str] = None, **overrides) -> Config:
    """Load a reference-format YAML (`configs/ape.yaml` schema) into a Config.

    Mirrors reference `arguments/argument.py:24-48` + `custom_cfg`.
    """
    import yaml

    with open(path, "r") as f:
        raw = yaml.safe_load(f)

    ds = raw.get("DATASETS", {})
    inp = raw.get("INPUT", {})
    mdl = raw.get("MODEL", {})
    sol = raw.get("SOLVER", {})
    tst = raw.get("TEST", {})

    data = DataConfig(
        train_list=ds.get("TRAIN", ""),
        valid_list=ds.get("VALID", ""),
        test_list=ds.get("TEST", ""),
        mesh_dir=ds.get("MESH_DIR", ""),
        bbox_file=ds.get("BBOX_FILE", ""),
        n_class=int(ds.get("N_CLASS", 16)),
        mesh_diameters=tuple(ds.get("MESH_DIAMETERS", _LINEMOD_DIAMETERS)),
        symmetry_types=_sym_to_tuple(ds.get("SYMMETRY_TYPES", {})),
        internal_width=int(inp.get("INTERNAL_WIDTH", 640)),
        internal_height=int(inp.get("INTERNAL_HEIGHT", 480)),
        internal_K=tuple(inp.get("INTERNAL_K", _LINEMOD_INTERNAL_K)),
    )
    model = ModelConfig(
        backbone=backbone or mdl.get("BACKBONE", "darknet_tiny_h"),
        anchor_sizes=tuple(mdl.get("ANCHOR_SIZES", (32, 64, 128, 256, 512))),
        anchor_strides=tuple(mdl.get("ANCHOR_STRIDES", (8, 16, 32, 64, 128))),
        use_higher_levels=bool(mdl.get("USE_HIGHER_LEVELS", True)),
        input_res=int(mdl.get("INPUT_RES", 256)),
    )
    solver = SolverConfig(
        ims_per_batch=int(sol.get("IMS_PER_BATCH", 16)),
        base_lr=float(sol.get("BASE_LR", 1e-3)),
        max_iter=int(sol.get("MAX_ITER", 10000)),
        val_freq=int(sol.get("VAL_FREQ", _BACKBONE_SPECS[model.backbone]["val_freq"])),
        loss_weight_cls=float(sol.get("LOSS_WEIGHT_CLS", 0.1)),
        loss_weight_reg=float(sol.get("LOSS_WEIGHT_REG", 1.0)),
        loss_reg_type=str(sol.get("LOSS_REG_TYPE", "3D")),
        positive_type=str(sol.get("POSITIVE_TYPE", "SSC")),
        positive_lambda=float(sol.get("POSITIVE_LAMBDA", 1.0)),
        regression_type=str(sol.get("REGRESSION_TYPE", "POINT")),
        aug_shift=float(sol.get("AUGMENTATION_SHIFT", 0.05)),
        aug_scale=float(sol.get("AUGMENTATION_SCALE", 0.05)),
        aug_rotation=float(sol.get("AUGMENTATION_ROTATION", 10.0)),
        aug_color_h=float(sol.get("AUGMENTATION_ColorH", 0.0)),
        aug_color_s=float(sol.get("AUGMENTATION_ColorS", 0.0)),
        aug_color_v=float(sol.get("AUGMENTATION_ColorV", 0.0)),
        aug_sharpen=float(sol.get("AUGMENTATION_Sharpen", 0.0)),
        aug_smooth=float(sol.get("AUGMENTATION_Smooth", 0.0)),
        aug_noise=float(sol.get("AUGMENTATION_Noise", 0.0)),
        aug_occlusion=float(sol.get("AUGMENTATION_OCCLUSION", 0.0)),
    )
    test = TestConfig(
        ims_per_batch=int(tst.get("IMS_PER_BATCH", 8)),
        confidence_th=float(tst.get("CONFIDENCE_TH", 0.1)),
    )
    cfg = Config(data=data, model=model, solver=solver, test=test)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
