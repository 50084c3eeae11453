"""A frozen copy of the port's host verifier and the host arithmetic under it.

The halo2 KZG/SHPLONK verifier, its Blake2b transcript, the pinned-key
Debug string, bn254 and secp256k1 field and curve arithmetic, the bn254
pairing and the ChaCha20 stream of the reference SRS's tau, copied from
``halo2_lib_tpu_torch`` (``backend/verifier.py``, ``protocol.py``,
``transcript.py``, ``pinned.py``, ``keygen.py``'s ``VerifyingKey``;
``utils/fields.py``, ``curves.py``, ``bn254_pairing.py``, ``chacha.py``)
with their imports made local. Nothing here imports the program, so a
fault introduced into the program's copies cannot hide from this one.
"""
