"""PyTorch/CUDA port of diffdart_tpu (the JAX package beside it is the
reference). Imports torch, never jax, and nothing of diffdart_tpu.

Each subpackage and module is the counterpart of the JAX package's module
of the same name:

  math/          diffdart_tpu/math/          Lie groups, spatial algebra
  dynamics/      diffdart_tpu/dynamics/      Model, State, joints, kinematics, dynamics
  collision/     diffdart_tpu/collision/     narrowphase, convex hulls, contact selection
  constraints/   diffdart_tpu/constraints/   LCP row assembly
  ops/           diffdart_tpu/ops/           LCP solvers and the hand-written CUDA kernels
                                             (ops/csrc/) of the Pallas kernels
  sim/           diffdart_tpu/sim/           the vmap stack, the fused path, World, recordings
  neural/        diffdart_tpu/neural/        timestep Jacobians, IK mappings
  trajectory/    diffdart_tpu/trajectory/    iLQR, shooting, NLP, MPC
  io/            diffdart_tpu/io/            URDF, SKEL, SDF, MJCF, VSK and mesh loaders
  models/        diffdart_tpu/models/        model builders and scenes
  parallel/      diffdart_tpu/parallel/      data-parallel gradients on torch.distributed
  utils/         diffdart_tpu/utils/         profiling, checkpoints
  viewer/        diffdart_tpu/viewer/        scene JSON, HTML export, WebSocket server
  torch_bridge   diffdart_tpu/torch_bridge   timestep, an alias of the native step

diffdart_tpu/assets/atlas/generate.py, which authored the Atlas-class
humanoid's URDF and meshes, has no counterpart: models/humanoid.py reads
its committed output.
"""

__version__ = "0.1.0"
