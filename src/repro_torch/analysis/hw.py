"""NVIDIA H100 SXM constants (per card, NVIDIA's data sheet, dense rates
without sparsity, at the 700 W power limit) used by the roofline model
and by ``chip_smoke.py``'s bounds. Counterpart of ``repro.analysis.hw``,
whose v5e numbers these replace under the same names where they carry
over. A card set below 700 W runs slower than these rates under load."""

PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bf16 on the tensor cores
PEAK_OPS_INT8 = 1979e12         # OP/s, int8 on the tensor cores
PEAK_FLOPS_FP32 = 67e12         # FLOP/s, fp32 outside the tensor cores
                                # (the port's fp32 GEMMs run with TF32 off)
HBM_BW = 3.35e12                # B/s
HBM_BYTES = 80e9                # the sheet's 80 GB
# B/s per direction per card: NVLink's 900 GB/s bidirectional. It takes
# the place of the v5e's ICI_BW_PER_LINK (one ICI link's rate).
NVLINK_BW = 450e9

DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "s32": 4, "s16": 2, "s8": 1, "u64": 8, "u32": 4, "u16": 2,
    "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}
