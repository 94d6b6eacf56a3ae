"""Published peaks of the card the cells run on (NVIDIA H100 SXM5 80 GB
data sheet, at its 700 W limit)."""

H100_HBM_BYTES_PER_S = 3.35e12
