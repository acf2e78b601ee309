"""Published peaks of the devices the benchmark runs on (dense rates,
without sparsity), by a substring of the name the driver reports.

NVIDIA H100 SXM (data sheet): 495 TFLOP/s TF32 on the tensor cores, 67
TFLOP/s fp32 outside them, 989 TFLOP/s bf16, 3.35 TB/s HBM3; at a power
limit of 700 W.
"""

PEAKS = {
    "H100": {"tf32_flops": 495e12, "fp32_flops": 67e12, "bf16_flops": 989e12,
             "hbm_bytes": 3.35e12},
}


def peaks(device_name):
    """The peaks of a device, or None for one not in the table."""
    for key, value in PEAKS.items():
        if key in device_name:
            return value
    return None
