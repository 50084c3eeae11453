"""The plain reference that decides whether a run is correct.

Plain Python ints and NumPy; nothing here imports the program
(``halo2_lib_tpu_torch``), the JAX package or JAX. Where the reference
needs the host algorithms of halo2 (curve arithmetic, the transcript, the
verifier's pairing), ``halo2/`` holds a frozen copy of them. Inputs are
made by the benchmark from the run's seed and handed to both sides; what the
program derived from them (an SRS, a key, prepared tables) the reference
works out again from first principles or checks against a digest frozen
from an independent implementation.
"""
