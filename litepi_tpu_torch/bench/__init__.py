"""The detector and classifier benches of the port (the JAX package's
``litepi_tpu/bench/{detector,classifier}_bench.py``)."""
