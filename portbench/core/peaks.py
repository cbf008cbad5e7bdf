"""Published peaks of the card, the yardstick of every roofline and MFU.

NVIDIA H100 SXM5 (the data sheet, dense rates, no sparsity, at its full
700 W): 989 TFLOP/s in bf16 and fp16 on the tensor cores, 3.35 TB/s of
HBM3. A card set below 700 W runs under these peaks; the result line
names the card, and the records give its power limit beside each number.
"""
from __future__ import annotations

H100_SXM = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}

# by a substring of torch.cuda.get_device_name()
TABLE = {"H100": H100_SXM}


def of(device_name):
    """The peaks of the card named ``device_name``; the H100 SXM's for a
    name the table lacks (the CPU tests), which only the card's own runs
    report as device numbers."""
    for key, peaks in TABLE.items():
        if key in device_name:
            return peaks
    return H100_SXM
