"""The frozen yardstick: the least work of batch identification and the
card's peaks, from which the per-layer roofline shares and `predict_mfu`
are read. Nothing here comes from the program under test."""
