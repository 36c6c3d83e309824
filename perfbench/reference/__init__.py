"""The benchmark's plain reference: plain torch and numpy, at float32, with
no import of the program under test, of JAX or of the JAX package.
`pipeline.scores` maps padded signals to [B, S] scores from the raw inputs
the benchmark makes (the signals, their lengths and the bank's weights,
means and sigmas)."""
