"""Shared constants for the DeepNVM++ reproduction.

GPU-mode constants model the paper's platform (NVIDIA GTX 1080 Ti, 16nm,
3 MB L2, 128 B lines, GDDR5X). TPU-mode constants (crosslayer) model a
v5e-class chip where the "LLC" is an on-chip SRAM tier and "DRAM" is HBM.
"""

# --- cache geometry --------------------------------------------------------
LINE_BYTES = 128                     # L2 line == one transaction
MB = 1 << 20

# --- paper platform (GTX 1080 Ti) -----------------------------------------
GPU_L2_MB = 3
GPU_CLOCK_GHZ = 1.481                # core/L2 clock
GPU_MEM_CLOCK_GHZ = 2.750

# --- DRAM (GDDR5X-class) ---------------------------------------------------
# Energy per 128B DRAM transaction. ~20 pJ/bit access+IO at GDDR5X-class
# interfaces -> 128 * 8 * 20 pJ ~= 20 nJ; latency ~ a few hundred core cycles.
DRAM_ENERGY_NJ = 20.0
DRAM_LATENCY_NS = 180.0
DRAM_IDLE_POWER_MW = 0.0             # background power folded into GPU board

# --- iso-area / miss model -------------------------------------------------
# Power-law miss exponent: solves Fig 7's (7MB, 14.6%) and (10MB, 19.8%)
# DRAM-access reductions from the 3MB baseline (see core/dram.py).
MISS_ALPHA = 0.186

# --- TPU v5e-class (crosslayer mode) ---------------------------------------
TPU_PEAK_FLOPS = 197e12
TPU_HBM_BW = 819e9
TPU_HBM_ENERGY_NJ_PER_128B = 128 * 8 * 0.004   # ~4 pJ/bit HBM2e-class
TPU_SRAM_TIER_MB = 128               # modeled on-chip last-level SRAM tier
TPU_CLOCK_GHZ = 0.94
