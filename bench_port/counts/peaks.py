"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): operations per second by the
precision a configuration computes in, and device memory bandwidth."""

FLOP_PER_S = {
    "bfloat16": 989e12,     # tensor cores, bf16 in, float32 accumulate
    "tf32": 495e12,
    "float32": 67e12,       # outside the tensor cores (TF32 off)
}
HBM_BYTES_PER_S = 3.35e12


def peak_flops(precision):
    return FLOP_PER_S[precision]
