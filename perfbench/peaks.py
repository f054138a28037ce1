"""Published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the
full 700 W power limit), the yardstick of every roofline and MFU share.

They are the card's, not the program's: an fp32 product counts against
one TF32 pass (the fastest the tensor cores multiply fp32 inputs),
whatever algorithm the program runs it in.
"""

TF32_FLOPS = 495e12        # tensor cores, TF32 inputs
FP32_SIMT_FLOPS = 67e12    # fp32 outside the tensor cores (depthwise, ladder)
HBM_BYTES_PER_S = 3.35e12  # HBM3
