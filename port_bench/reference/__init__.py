"""The plain reference: float32 PyTorch (TF32 off) and float64 NumPy.

It imports nothing of the program (``idiaptts_torch``), nor ``jax`` nor
``idiaptts_tpu``, and takes nothing the program made: it gets the
benchmark's seeded weights and inputs and works out the padding, the
batches, the MLPG systems and the vocoder's noise draw itself.
"""
