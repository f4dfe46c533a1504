"""neo360_tpu_torch — the PyTorch / CUDA port of `neo360_tpu`, for one
NVIDIA H100 (Hopper, sm_90a).

The JAX package beside it is the reference: every module here mirrors the
JAX module of the same name, loads the same weights (`weights.py`) and is
held against it by the `tests/test_torch_*.py` parity tests.

The ported presets are `neo360` and `neo360_fast` (`cli.run_train`:
the per-step and the scene-mixed encode-once stage trainers, the optimize
and LPIPS-finetune modes), the vanilla NeRF (the ray-buffer trainer),
PixelNeRF (the per-step trainer) and MipNeRF-360 (the ray-buffer trainer,
`models/mipnerf360.py`); `cli.run_eval --eval_mode full_eval|vis_only`
evaluates each (the few-shot models encode a scene's source views once,
then render novel views tile by tile). Hand-written CUDA kernels carry
their hot ops (`csrc/`), forward and backward, each behind a
`torch.autograd.Function`: the corner-table bilinear gather (A), its
fused tri-plane and local variants and its scatter-add (A′)
(`ops/interpolate.py`); the NeRF++ fg/bg composite (B / B′), the plain
NeRF composite (D / D′) and MipNeRF-360's composite (E / E′) with their
reverse scans (`core/render.py`); the softmax pillar collapse and its
backward (C / C′, `ops/pillar.py`); and the image bilinear sample and its
scatter-add (G / G′, `ops/interpolate.py:grid_sample_2d`). On CPU tensors
each wrapper runs its plain PyTorch version instead. `ops/kernels.py`
builds and binds them and counts every launch (`kernels.launches`).

Layers depend one way: `core`, `ops`, `nn`, `models` and `data` import
nothing of `train`, `parallel`, `cli` or `bench`; the span recorder the
models time themselves with is `core/spans.py`.

Nothing here imports jax, flax, optax or `neo360_tpu`.
"""

__version__ = "0.1.0"
