"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet), at its
full power limit of 700 W; the set-up log line gives the card's own
limit beside every run."""

HBM_BYTES_PER_S = 3.35e12
