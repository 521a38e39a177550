"""spr_pick_tpu_torch — the PyTorch/CUDA port of spr_pick_tpu for NVIDIA
Hopper GPUs.

The JAX package `spr_pick_tpu` is the unchanged reference: this package
follows its module layout, imports nothing of it (nor jax, flax or optax),
and is tested against it on the CPU.  Its one hand-written kernel, the
greedy NMS K1 (`csrc/nms.cu`), replaces the JAX package's Pallas kernel.
Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""
