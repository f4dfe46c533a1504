"""Experiment configuration (copy of neo360_tpu/config.py: the reference's
argparse flags as one dataclass with the four experiment presets).

Model-size overrides are added for the port, `encoder_width`,
`num_prop_samples` and the JAX NeRFTP's width fields `plane_dim`,
`local_proj_dim`, `pillar_width` and `depth_fc_layers` (which the JAX
package's bench.py sets), so that a cut-down or narrowed NeO-360 model can
be built through `cli.build_model`, and the torch `device` of the CLI
runs.

Model hyperparameters that the reference hardcodes in constructors (sample
counts, MLP shapes) live on the model classes; this config carries the
run-level knobs.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

EXP_TYPES = ("vanilla", "mipnerf360", "pixelnerf", "neo360", "neo360_fast")
# reference name for neo360: "triplanar_nocs_fusion_conv_scene" (run.py:41).
# neo360_fast: same conditioning stack, proposal-culled sampling (no
# reference analogue — TPU-first fast path, models/neo360.py use_proposal).
EXP_ALIASES = {"triplanar_nocs_fusion_conv_scene": "neo360"}


@dataclass
class Config:
    # experiment
    exp_type: str = "neo360"
    exp_name: str = "exp"
    root_dir: str = ""
    dataset_name: str = "nerds360"         # nerds360 | nerds360_ae
    img_wh: Tuple[int, int] = (320, 240)
    white_back: bool = False

    # sampling / rendering
    batch_size: int = 1024                 # rays per step (vanilla/mip)
    ray_batch_size: int = 500              # rays per AE sample (few-shot)
    chunk: int = 256                       # eval rays per tile (VMEM knee,
                                           # BASELINE.md 2026-08-20 re-sweep)
    num_src_views: int = 3
    lift_dim: Optional[int] = None         # grid-lift row width (neo360_fast
                                           # preset: 128; None = reference)
    # model-size overrides (None = the preset's reference defaults); used by
    # capacity studies and the tiny-shape multichip dryrun
    grid_size: Optional[Tuple[int, int, int]] = None
    num_coarse_samples: Optional[int] = None
    num_fine_samples: Optional[int] = None
    # None = the model's default (True: recompute the encoder in backward to
    # save HBM). False shrinks the compiled program — used by the tiny-shape
    # multichip dryrun where SPMD compile time, not memory, is the binding
    # constraint.
    remat_encoder: Optional[bool] = None
    encoder_width: Optional[int] = None    # GridEncoder latent width
    num_prop_samples: Optional[int] = None # neo360_fast proposal samples
    # NeRFTP width fields (None = the model's reference default)
    plane_dim: Optional[int] = None        # tri-plane channels
    local_proj_dim: Optional[int] = None   # projected pixel-latent width
    pillar_width: Optional[int] = None     # pillar aggregator hidden width
    depth_fc_layers: Optional[int] = None  # DepthPillarEncoder hidden layers
    # PixelNeRF's network: "nerf", the JAX package's 4 x 128 MLP, or
    # "resnet", the published ResnetFC (pixel-nerf conf/default_mv.conf:
    # 5 x 512, the views averaged before block 3, 64 + 16 + 16 samples)
    mlp_type: str = "nerf"
    # scenes in a per-step training batch (pixelnerf): the ray_batch_size
    # rays split evenly over them, each with its own source views
    scenes_per_step: int = 1

    # optimization
    bf16: bool = False                     # bf16 compute in encoders/MLPs
    run_max_steps: int = 100000
    lr_init: float = 5.0e-4
    lr_final: float = 5.0e-6
    lr_delay_steps: int = 2500
    lr_delay_mult: float = 0.01
    grad_max_norm: float = 0.0             # 0 = no clipping
    steps_per_call: int = 100              # fori_loop steps per jit call
    # scene-stage (encode-once) trainer (train/loop.py
    # make_scene_stage_trainer): a stage = stage_k consecutive steps against
    # frozen encoder tables, encoder updated once per stage via exact
    # VJP-pullback gradient accumulation. stage_scenes > 1 = SCENE-MIXED
    # stages (each step's rays drawn from all S scenes — required for
    # quality; single-scene stages measured -4 dB at K=4). 0/1 = reference
    # per-step encoding. neo360/neo360_fast only.
    stage_k: int = 0
    stage_scenes: int = 1
    # hybrid schedule: per-step-encode training for the first N steps (fresh
    # encoder gradients through the staleness-sensitive early phase), then
    # encode-once stages. Ignored when resuming past it or stage_k <= 1.
    stage_warmup_steps: int = 0
    # stage cotangent-accumulator dtype: with "float32" the tables' backward
    # adds straight into the accumulators; another dtype casts and adds each
    # step's dense table gradient (train/loop.py make_scene_stage_trainer)
    stage_cot_dtype: str = "float32"

    # run modes
    eval_mode: Optional[str] = None        # None | full_eval | vis_only
    render_name: str = "3views"
    is_optimize: bool = False              # few-shot test-time optimization
    finetune_lpips: bool = False
    ckpt_dir: str = "ckpts"
    ckpt_path: Optional[str] = None
    lpips_weights: Optional[str] = None    # torch VGG16+lin checkpoint
    resnet_weights: Optional[str] = None   # torchvision resnet34 state_dict

    # few-shot eval encode BN mode: "batch" re-derives BatchNorm statistics
    # from the 3-5 source views at encode time; "running" uses the trained
    # running averages (the reference's torch eval() semantics). Default
    # "batch": measured +3.8 dB (per-step-trained) / +1.3 dB (stage-trained)
    # mean val PSNR on the fixture drive (BASELINE.md round 3) — the source
    # stack is tiny and scene-specific, so its own statistics beat a global
    # running average.
    eval_bn_mode: str = "batch"

    # eval cadence
    val_every_steps: int = 5000
    save_every_steps: int = 5000
    log_every_steps: int = 100

    seed: int = 0
    # port only: the torch device of run_train / run_eval (cli --device);
    # a CUDA device that is absent raises
    device: str = "cuda"

    def __post_init__(self):
        # a typo'd mode would otherwise silently fall through to running
        # stats (every use site tests == "batch"), changing eval numbers
        # by 1.3-3.8 dB with no error
        if self.eval_bn_mode not in ("batch", "running"):
            raise ValueError(
                f"eval_bn_mode must be 'batch' or 'running', got "
                f"{self.eval_bn_mode!r}")

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def preset(exp_type: str, **overrides) -> Config:
    """The four reference presets (SURVEY §2.3)."""
    exp_type = EXP_ALIASES.get(exp_type, exp_type)
    if exp_type == "vanilla":
        cfg = Config(exp_type="vanilla", dataset_name="nerds360",
                     batch_size=2048, lr_init=5e-4, lr_final=5e-6,
                     lr_delay_steps=2500)
    elif exp_type == "mipnerf360":
        cfg = Config(exp_type="mipnerf360", dataset_name="nerds360",
                     batch_size=2048, lr_init=2e-3, lr_final=2e-5,
                     lr_delay_steps=512)
    elif exp_type == "pixelnerf":
        cfg = Config(exp_type="pixelnerf", dataset_name="nerds360_ae",
                     lr_init=5e-4, lr_final=5e-6)
        if overrides.get("mlp_type") == "resnet":
            # the published training: 4 objects x 128 rays a step, Adam
            # at a constant 1e-4 (pixel-nerf train/train.py -B 4 -R 128)
            cfg = cfg.replace(ray_batch_size=512, scenes_per_step=4,
                              lr_init=1e-4, lr_final=1e-4,
                              lr_delay_steps=0)
    elif exp_type == "neo360":
        cfg = Config(exp_type="neo360", dataset_name="nerds360_ae",
                     lr_init=5e-4, lr_final=5e-6, grad_max_norm=0.05)
    elif exp_type == "neo360_fast":
        # stage_k/stage_scenes: scene-mixed encode-once stages are the
        # production trainer — quality-gated on the fixture drive (round-3
        # BASELINE.md 6-view A/B at matched 1408 steps: K=32 S=2 26.86 vs
        # per-step control 25.39 vs K=16 25.89 mean val PSNR, batch-stats
        # encode) at ~1.7-1.8x the per-step train throughput.
        cfg = Config(exp_type="neo360_fast", dataset_name="nerds360_ae",
                     lr_init=5e-4, lr_final=5e-6, grad_max_norm=0.05,
                     bf16=True, lift_dim=128, stage_k=32, stage_scenes=2,
                     num_fine_samples=60)
    else:
        raise ValueError(f"unknown exp_type {exp_type!r}; "
                         f"expected one of {EXP_TYPES}")
    return cfg.replace(**overrides)
