"""The system under test, as its users run it: the only module of the
benchmark that imports neo360_tpu_torch.

`Program` builds the configuration's model through the port's CLI
(`cli.build_model` on the preset the configuration names, with the
configuration's sizes), loads the benchmark's seeded weights into it by
its `state_dict` names, and drives one item of a traffic mix at a time
through the port's own entries:
- "stage": `loop.make_scene_stage_trainer` on `make_scene_stage_fns`,
  each partition's optimizer from `cli.build_optimizer`;
- "step": `loop.make_staged_trainer(loop.make_train_step(
  cli.make_loss_fn(...)))`, one step a call;
- "view": `model.encode` once in set-up, then `loop.make_image_renderer`
  over the view in the preset's tiles (rgb and depth).
The trainer's knobs (K, S, the tile, the recompute, the cotangent dtype,
BatchNorm's eval mode) are the preset's as the CLI builds them.
"""

from __future__ import annotations

from typing import Dict, List

import torch

# configuration keys that are fields of the port's Config
SIZE_KEYS = ("grid_size", "num_coarse_samples", "num_prop_samples",
             "num_fine_samples", "encoder_width", "lift_dim", "plane_dim",
             "local_proj_dim", "pillar_width", "depth_fc_layers",
             "ray_batch_size", "num_src_views")


def kernel_library() -> None:
    """Build (first run in a checkout) or load the port's kernels."""
    from neo360_tpu_torch.ops import kernels
    kernels.build()
    kernels.library()


class Program:
    def __init__(self, config: Dict, seed: int, device: torch.device,
                 generator_seed: int):
        from neo360_tpu_torch import cli
        from neo360_tpu_torch.config import preset
        from neo360_tpu_torch.nn.triplane import GridEncoder
        self.cli = cli
        sizes = {k: config[k] for k in SIZE_KEYS if k in config}
        if sizes.get("grid_size") is not None:
            sizes["grid_size"] = tuple(sizes["grid_size"])
        cfg = preset(config["exp_type"], seed=seed % 2 ** 31,
                     device=str(device), **sizes)
        cfg = cfg.replace(bf16=config["precision"] == "bfloat16")
        if tuple(GridEncoder.plane_hw) != tuple(config["plane_hw"]):
            raise ValueError(f"the program's tri-planes are "
                             f"{GridEncoder.plane_hw}, the configuration's "
                             f"{config['plane_hw']}")
        self.cfg = cfg
        self.device = device
        cli.float32_matmuls(cfg, device)
        self.model = cli.build_model(cfg, device)
        self.generator = torch.Generator(device).manual_seed(generator_seed)
        self.runner = self.state = None
        self.recorded: List[torch.Tensor] = []
        self.recording = False

    # ---------------------------------------------------------------- set-up
    def shapes(self) -> Dict[str, tuple]:
        return {k: tuple(v.shape) for k, v in self.model.state_dict().items()}

    def trained_names(self) -> List[str]:
        return [k for k, p in self.model.named_parameters()
                if p.requires_grad]

    def load(self, weights: Dict[str, torch.Tensor]) -> None:
        self.model.load_state_dict(weights, strict=True)

    def trainer_kind(self) -> str:
        return "scene_stage" if self.cfg.stage_k > 1 else "per_step"

    def make_trainer(self) -> None:
        from neo360_tpu_torch.models.neo360 import make_scene_stage_fns
        from neo360_tpu_torch.train import loop
        cfg, cli, model = self.cfg, self.cli, self.model
        model.train()
        make_opt = lambda params: cli.build_optimizer(cfg, params)
        if self.trainer_kind() == "scene_stage":
            encode_fn, loss_fn = make_scene_stage_fns(
                model, cfg.white_back, mixed=cfg.stage_scenes > 1)

            def recording_loss(*args, **kw):
                loss, metrics = loss_fn(*args, **kw)
                if self.recording:
                    self.recorded.append(loss.detach())
                return loss, metrics

            self.state = loop.create_scene_stage_state(model, make_opt)
            stage = loop.make_scene_stage_trainer(
                encode_fn, recording_loss,
                cot_dtype=getattr(torch, cfg.stage_cot_dtype))
            keys = cli.SRC_KEYS

            def run(item):
                src = {k: item[k] for k in keys}
                rays = {k: item[k] for k in cli.STAGE_RAY_KEYS}
                return stage(self.state, src, rays, self.generator)
        else:
            self.state = loop.create_train_state(model, make_opt)
            step = loop.make_staged_trainer(loop.make_train_step(
                cli.make_loss_fn(cfg, model), with_model_state=True))

            def run(item):
                metrics = step(self.state, {k: item[k][None]
                                            for k in cli.STEP_KEYS},
                               self.generator)
                if self.recording:
                    self.recorded.append(metrics["loss"].detach())
                return metrics
        self.runner = run

    def moments(self) -> Dict[str, torch.Tensor]:
        """Each trained leaf's Adam first moment, by name."""
        st = self.state
        pairs = []
        if hasattr(st, "opt"):
            pairs.append((st.params, st.opt))
        else:
            pairs += [(st.enc_params, st.enc_opt), (st.ray_params,
                                                    st.ray_opt)]
        return {n: m for params, opt in pairs
                for n, m in zip(params, opt.mu)}

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: p.detach() for k, p in self.model.named_parameters()}

    def make_renderer(self, src: Dict[str, torch.Tensor]) -> None:
        """Encode the scene (set-up) and bind the tile renderer."""
        from neo360_tpu_torch.models.neo360 import SRC_KEYS
        from neo360_tpu_torch.train import loop
        cfg, model = self.cfg, self.model
        model.eval()
        batch_stats = cfg.eval_bn_mode == "batch"
        with torch.inference_mode():
            enc = model.encode(*(src[k] for k in SRC_KEYS), batch_stats)

        def render_chunk(pack, chunk):
            out = model(dict(chunk, **src), pack, cfg.white_back,
                        out_depth=True)[1]
            return {"rgb": out["rgb"], "depth": out["depth"]}

        renderer = loop.make_image_renderer(render_chunk, cfg.chunk)
        self.runner = lambda rays: renderer(enc, rays)

    def free(self) -> None:
        self.runner = self.state = self.model = None
        self.recorded = []
