"""The chip's peaks and the kernels' roofline bounds, from shapes (copied
arithmetic of `chip_smoke.py`'s `conv_bound` / `k2_bound` and of its K1
bound, so that the yardstick does not move with them).

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
limit): 989 TFLOP/s bf16, 495 TF32, 67 fp32 on the CUDA cores, 3.35 TB/s of
HBM3; the special-function units' expf / logf at 16 a cycle on each of 132
SMs at 1.98 GHz. An fp32 product that stays fp32-accurate on the tensor
cores takes three TF32 products (3xTF32), so the fp32 peak of a network's
convolutions is 495 / 3 TFLOP/s: no fp32-accurate route can read past it.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
SFU_OPS_PER_S = 16 * 132 * 1.98e9

# a network's convolutions, by compute dtype
CONV_PEAK = {"float32": TF32_FLOPS / 3, "bfloat16": BF16_FLOPS}


def conv_bound(in_bytes: int, B: int, C: int, O: int, M: int, mma: bool = False,
               elem: int = 4) -> float:
    """Least seconds of a fused 3x3 conv + affine + LeakyReLU writing (B, O,
    M): bytes = the input once, the weights, the fp32 scale and bias, the
    output once; operations = the products (fp32 on the CUDA cores, or
    with `mma` three TF32 products each on the tensor cores; bf16 on the
    tensor cores) plus the affine in fp32."""
    nbytes = in_bytes + elem * 9 * O * C + 4 * 2 * O + elem * B * O * M
    conv = B * M * O * 2 * 9 * C
    flops = conv + 2 * B * M * O
    if elem == 2:
        op_s = conv / BF16_FLOPS + (flops - conv) / FP32_FLOPS
    elif mma:
        op_s = 3 * conv / TF32_FLOPS + (flops - conv) / FP32_FLOPS
    else:
        op_s = flops / FP32_FLOPS
    return max(nbytes / HBM_BYTES_PER_S, op_s)


def k2_bound(B: int, C: int, O: int, H: int, W: int, elem: int = 4) -> float:
    """K2 (the flat form) on its (B, C, (H + 2)(W + 2) + 2) slab; in fp32
    every shape but the stem's 3 -> 8 runs its products on the tensor
    cores."""
    return conv_bound(elem * B * C * ((H + 2) * (W + 2) + 2), B, C, O, H * (W + 2),
                      mma=(C, O) != (3, 8), elem=elem)


def k1_bound(N: int, P: int, T: int, n_eps: int, debias: bool = True) -> float:
    """Least seconds of one K1 solve of N problems of P x T points over
    n_eps steps: per eps 4 softmin passes (2 without debias), one expf per
    (row, column) and one logf per row on the SFUs, ~10 fp32 operations per
    (row, column); bytes the clouds, log-weights and potentials once."""
    nbytes = 4 * N * (3 * P + 3 * T) + 4 * N * 2 * (P + T)
    pairs = N * n_eps * (2 * P * T + (P * P + T * T if debias else 0))
    sfu = pairs + N * n_eps * (2 if debias else 1) * (P + T)
    return max(nbytes / HBM_BYTES_PER_S, sfu / SFU_OPS_PER_S, 10 * pairs / FP32_FLOPS)
