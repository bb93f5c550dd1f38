"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the card's
700 W limit): what every share of a peak or a roofline is taken against."""

TF32_FLOPS = 495e12  # tensor cores; bounds any f32-accurate product on the card
HBM_BYTES_PER_S = 3.35e12
