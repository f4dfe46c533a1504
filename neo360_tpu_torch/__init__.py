"""neo360_tpu_torch — the PyTorch / CUDA port of `neo360_tpu`, for one
NVIDIA H100 (Hopper, sm_90a).

The JAX package beside it is the reference: every module here mirrors the
JAX module of the same name, loads the same weights (`weights.py`) and is
held against it by the `tests/test_torch_*.py` parity tests.

The ported presets are `neo360` and `neo360_fast` (`cli.run_train`:
the per-step and the scene-mixed encode-once stage trainers, the optimize
and LPIPS-finetune modes), the vanilla NeRF (the ray-buffer trainer) and
PixelNeRF (the per-step trainer); `cli.run_eval --eval_mode
full_eval|vis_only` evaluates each (the few-shot models encode a scene's
source views once, then render novel views tile by tile). Hand-written
CUDA kernels carry their hot ops (`csrc/`), forward and backward, each
behind a `torch.autograd.Function`: the corner-table bilinear gather, its
fused tri-plane and local variants and its scatter-add
(`ops/interpolate.py`), the NeRF++ fg/bg composite and the plain NeRF
composite with their reverse scans (`core/render.py`) and the softmax
pillar collapse and its backward (`ops/pillar.py`). On CPU tensors each
wrapper runs its plain PyTorch version instead.

Nothing here imports jax, flax, optax or `neo360_tpu`.
"""

__version__ = "0.1.0"
