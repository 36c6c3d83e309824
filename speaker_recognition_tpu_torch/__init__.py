"""PyTorch + CUDA port of speaker_recognition_tpu: batched predict,
enrollment (EM, UBM, MAP) and open-set serial scoring.

The JAX package beside this one is the reference: same configs, same
session artifact, same scores. On CUDA tensors the frontend and the bank
scoring run hand-written kernels (csrc/); on CPU tensors they run their
plain torch versions.
"""
