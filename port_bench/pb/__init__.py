"""The harness of the port's benchmark: spec lookup, traffic generation,
seeded weights, the adapter to the program, tracing and the result line.

Nothing here imports ``jax``, ``flax``, ``optax`` or ``idiaptts_tpu``;
the program (``idiaptts_torch``) is imported only by ``pb.program`` and
the drivers.
"""
