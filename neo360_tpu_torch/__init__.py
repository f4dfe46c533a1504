"""neo360_tpu_torch — the PyTorch / CUDA port of `neo360_tpu`, for one
NVIDIA H100 (Hopper, sm_90a).

The JAX package beside it is the reference: every module here mirrors the
JAX module of the same name, loads the same weights (`weights.py`) and is
held against it by the `tests/test_torch_*.py` parity tests.

The ported slices are the `neo360_fast` scene-stage trainer
(`cli.run_train`: scene-mixed, encode-once stages) and the few-shot eval
(`cli.run_eval --eval_mode full_eval`: encode the source views once, then
render novel views tile by tile). Six hand-written CUDA kernels carry
their hot ops (`csrc/`), forward and backward, each behind a
`torch.autograd.Function`: the corner-table bilinear gather and its
scatter-add (`ops/interpolate.py`), the NeRF++ fg/bg composite and its
reverse scan (`core/render.py`) and the softmax pillar collapse and its
backward (`ops/pillar.py`). On CPU tensors each wrapper runs its plain
PyTorch version instead.

Nothing here imports jax, flax, optax or `neo360_tpu`.
"""

__version__ = "0.1.0"
