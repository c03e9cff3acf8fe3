"""The plain reference of the benchmark: the networks, the training
objective and step, and the serving postprocess in plain PyTorch and
float32, importing nothing of the program (`kd6d_pose_adlp_tpu_torch`), of
JAX or of the JAX package. The benchmark hands it the same inputs and
weights as the program, and it works out again whatever the program
derives from them (the folded BatchNorm, the anchors, the constants)."""
