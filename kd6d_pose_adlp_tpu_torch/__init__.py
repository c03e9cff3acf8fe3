"""kd6d_pose_adlp_tpu_torch — the PyTorch / CUDA (H100, sm_90a) port of
`kd6d_pose_adlp_tpu`.

The JAX package beside it is the reference; this package imports nothing of
it (nor `jax`, `flax`, `optax` or `msgpack`) and keeps its own copies of the
pure-numpy modules it needs. Public functions keep the JAX layouts (NHWC
images, flat `(B, A, C)` per-cell outputs in NHWC cell order), so the tests
can hold every module against its JAX counterpart on the same inputs.

Ported so far: the serving path — `PoseNet` (darknet_tiny_h + FPN + head)
-> class-selected voting -> RANSAC-EPnP + LHM (`engine/serving.py`, modes
single and multi), with the fused 3x3 conv + BN-affine + LeakyReLU Pallas
kernels of the stem / s2 stages as hand-written CUDA
(`csrc/conv3x3_bn_act.cu`, `ops/conv_fused.py`); the KD training step and
loop (`engine/steps.py`, `engine/loop.py`, the Sinkhorn kernel in
`csrc/sinkhorn_potentials.cu`); evaluation (`engine/evaluator.py`,
`engine/eval_scan.py`, `utils/metrics.py`, the `evaluate` CLI); the rest
of the training loop (checkpoints and resume, reading the JAX package's
msgpack checkpoints, backbone init, the device pool with K steps per call,
the cached teacher, the `train_kd` CLI); bf16, the variants and the
folded teacher; the raw-frame endpoint, `torch.export` and int8 PTQ; the
dense binary-code (zebra) head (`ops/binary_code.py`, `engine/zebra.py`,
the `train_zebra` CLI); the BOP host pipeline (`data/`); data parallelism
over a torch.distributed group, one process a device (`parallel/mesh.py`,
`train_kd --n_devices` / `--distributed`).

Entry points run on the card (`device="cuda"`) unless the caller asks for
the CPU; on CPU tensors each kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
