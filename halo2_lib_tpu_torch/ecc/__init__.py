"""halo2-ecc equivalent layer (host code, copied from ``halo2_lib_tpu/ecc``):
non-native bigint arithmetic, emulated prime fields, elliptic-curve chips,
ECDSA, and the BN254 pairing."""
