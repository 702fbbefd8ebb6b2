"""The port's simulation subsystem: the round-quantized engine
(``engine.simulate_rounds``) and its records and results (``metrics``).
The JAX package's event engine, fault model and trace replay are not
ported yet."""
