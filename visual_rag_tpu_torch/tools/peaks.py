"""The H100 SXM's published peaks (NVIDIA's data sheet, dense, at 700 W), which
``chip_smoke.py`` and ``k10_ab.py`` set each kernel's least time by."""

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
