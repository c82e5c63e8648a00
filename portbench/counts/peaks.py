"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit). A card set below
700 W runs slower under load; the run prints its ``power.limit`` beside
every share of these peaks."""

HBM_BYTES_PER_S = 3.35e12

# FLOP/s by the precision an operation runs in: float32 outside the
# tensor cores (TF32 off), TF32, and bfloat16 / float16 tensor cores
PEAK_FLOPS = {
    "float32": 67e12,
    "tf32": 495e12,
    "bfloat16": 989e12,
    "float16": 989e12,
}

CARD = "NVIDIA H100 SXM (80 GB HBM3)"
