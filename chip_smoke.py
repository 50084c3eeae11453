#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (halo2_lib_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py [--ptxas] [--mesh-only] [--msm-only] [--api-only]

(--ptxas prints ptxas's report of every kernel; --mesh-only builds the
kernels and runs phase 10 alone, over every visible card: the multi-card
check; --msm-only builds them, checks them (phase 2) and runs phase 12
alone; --api-only the same with phase 13.) Phases, each
printing its own lines; any failure raises
and exits non-zero:

1. build   - compile the CUDA kernels from halo2_lib_tpu_torch/csrc (nvcc).
1b. engine - the host witness engine (halo2_lib_tpu_torch/native.py,
             csrc/host_engine.c): its earlier builds removed from _build/,
             built by cc and loaded; the gate chip's emitter and
             Context.assign_region's hook must hold it (every witness and
             column packing after this runs through it).
2. kernels - every kernel against its plain PyTorch version on the card, at a
             ragged size, bit for bit (ec_add and ec_madd with identity
             operands, P + P and P + (-P) lanes, ec_madd with (0, 0) bases and
             both `distinct` values; the MSM tail's bucket_weight at 2, 8 and
             64 lanes with empty, repeated and inverse bucket sums, and
             msm_combine at 1 and 42 columns with a doubling and an identity
             lane; bucket_sums_fused at 8, 16 and 256 lanes and a ragged
             window count, with a run across many lanes, one bucket filling a
             window, dead windows (digit 0), buckets below every digit, P + P
             (distinct False) and P + (-P) in a run, and also against the
             composition it replaced (bucket_scan, the lane-carry scan of
             single ec_add launches, the pick and the fix; kept here, not in
             the package); colntt at A = 2..1024, with and without the mid,
             ragged B, tw[0] random and the Montgomery one); ntt_small at n =
             2..2^11 and C = 1, 3, 12 and 65 columns, forward and inverse,
             without diagonals, with the pre row, the post scalar (1/n), the
             post row (shift^-i / n), and both with random twiddles, with 0,
             1, p - 1 and R mod p among the values, also against the per-stage
             composition it replaced (ntt_butterfly launches, the torch
             interleave and the mont_mul scalings: ops/ntt.py ntt_stages,
             the radix-2 route above 2^11 points); commit_dbl_add
             at (C, m) = (1, 1), (3, 13), (8, 512) and (3, 1024) with
             scalars 0, 1 and r - 1, an all-zero column and a (0, 0) base,
             also against the per-bit composition it replaced (ec_double,
             ec_madd, select, then the ec_add lane tree; kept here, not in
             the package); fermat_inv on both fields at [1, 16, 1],
             [11, 16, 1] and [3, 16, 1000] with 0, 1, p - 1, R mod p and
             2^-1 among random values. (The build prints the registers and
             spills of g1_fixed_mul_k, commit_chain_k, dft_ntt_k and
             dft_stage from ptxas's report, which lies beside the library,
             and fails without an entry for either new kernel.)
3. k=9     - keygen + create_proof of the golden circuit (seconds of each
             printed); the vk and proof bytes must equal the JAX package's
             goldens in tests/data/torch_goldens/. Its domains (2^9, 2^11)
             take the digit-plane DFT (MxuNTT), one dft_ntt launch per NTT
             call and no dft_stage or ntt_small, and its commits (m = 2^9 <=
             1024) the fused double-and-add, one
             commit_dbl_add launch per commit call, never Pippenger,
             ec_madd, ec_double or ec_add. Then one k=9 commit is timed three
             ways: the old per-bit loop, commit_dbl_add (Jacobian-equal to
             it) and Pippenger (equal in affine form).
3b. phases - the two other k=9 circuits: the two-phase RLC circuit
             (create_proof with phase_fns) and the RAM circuit (dynamic
             lookup): keygen, create_proof, verify_proof and a tampered proof
             rejected, vk and proof bytes equal to the JAX goldens
             (multiphase_k9.npz, dynlookup_k9.npz); launches and the NTT
             domains each took printed, one dft_ntt launch per NTT call
             below 2^12 points (MxuNTT), no dft_stage or ntt_small.
4. k=15    - keygen -> create_proof -> verify_proof of the slice circuit (4
             advice + 1 lookup column, every column 2^15 rows), with a
             tampered proof rejected and the proof's SHA-256 held against the
             JAX digest. Its domains (2^15, 2^17) take the four-step NTT
             (colntt) and its commits Pippenger (bucket_sums_fused).
4b. ECDSA  - the main path at full width: the repo's secp256k1 ECDSA-verify
             circuit (bench.py's, 18 advice + 3 lookup-advice + 1 fixed
             column at k=15): keygen, then the pinned prover builder's
             witness and create_proof, then verify_proof and a tampered proof
             rejected; the proof's and the vk's SHA-256 held against the JAX
             package's (ecdsa_k15.json).
             Kernel launch counts (and the NTT and commit calls) are reset
             just before phases 3, 3b, 4 and 4b and read just after each;
             every kernel must have launched in the phases whose paths run
             it: k=9 every kernel but colntt, ntt_small and the Pippenger
             ones (bucket_sums_fused, bucket_weight, msm_combine); k=15 and
             ECDSA every kernel but ntt_small, dft_stage, dft_ntt and
             commit_dbl_add (the MSM is bucket_sums_fused, bucket_weight and
             msm_combine, one launch each per MSM call). dft_ntt launches
             once per MxuNTT call (2^6..2^11 points; dft_stage, which runs
             only where MxuNTT is built directly above 2^11, on no path) and
             ntt_small once per radix-2
             NTT call in every phase (neither at k=15 and ECDSA, whose
             domains are 2^15 and 2^17). The literal ports ntt_butterfly,
             ec_madd, ec_double, ec_add and bucket_scan run on no path: 0
             launches in all of them. g1_batch_mul runs only where an SRS is
             made (phase 6).
6. srs +   - (runs before phase 5, whose table carries its launches) SRS
   pairing   creation on the card and the BN254 pairing circuit at
             configs/bn254/pairing_circuit.config (k=19, lookup_bits 18, 90-bit
             limbs): setup(12) and setup(15) byte for byte the committed
             params/ files (and setup(9)), a Processed round trip at k=12,
             g1_batch_mul (the comb) at 300 lanes with 0, 1, r - 1 and the
             comb's edge scalars against its plain version, the old
             double-and-add (affine) and the host curve;
             then, with the counts reset, gen_srs(19) makes the k=19 SRS on
             the card (one g1_batch_mul launch for both bases) into the
             git-ignored halo2_lib_tpu_torch/_build/params/, and the pairing
             circuit is keygen'd (MOCK builder), witnessed on the pinned
             PROVER builder and proved at seed 0, verified, a tampered proof
             rejected; every stage's seconds printed, the launches as
             `launches_pairing` (no ntt_small, no commit_dbl_add, colntt and
             every Pippenger kernel launched). Then the k=19 SRS: its
             g[:2^15] is the committed k=15 file's, 64 sampled Lagrange
             points are L_i(tau) G on the host, the written file reads back
             to the same bases; one MSM of 3 columns x 2^19 points on each
             basis equals p(tau) G (monomial) and sum_i v_i L_i(tau) G
             (Lagrange) on the host; the four-step NTT at 2^19 and 2^21
             (forward, inverse, coset both ways) equals the JAX NTT's digests
             (ntt_digests_large.json). The SRS, columns, vk and proof are
             held to each digest pairing_k19.json holds (the JAX run writes
             them stage by stage), and printed.
7. bench   - (phases 7-9 run after 6, before 5) the headline's own path:
             warm_prover on the ECDSA key of phase 4b, then bench.py's e2e
             region (the pinned prover builder's witness and create_proof,
             warm key) in turns plain, pipelined, pipelined, plain: the
             pipelined runs (backend/pipeline.py) commit the finished advice
             columns on a second CUDA stream while the witness runs. Every proof is
             byte-equal to the others and its SHA-256 to the JAX digest
             (ecdsa_k15.json); one verifies, a tampered copy is rejected. Each
             run's seconds and stages, the commit groups and the pipelined
             proof's launches (counts reset just before it) printed. Then the
             k=9 golden circuit pipelined (commit_dbl_add on the side stream):
             bytes equal to golden_k9.npz.
7b. engine - (after 7) phase 7's plain e2e region in turns host engine,
             Python path, Python path, engine (native.python_path: the
             witness's emitters and the column packing in Python): e2e,
             witness and the advice columns' _u16_cols seconds each way,
             every create_proof's _u16_cols packed again the other way with
             equal limbs, every proof the JAX digest; one
             {"engine_runs": ...} JSON line.
8. mock    - DeviceMockProver (the gate stencil through mont_mul, field_add
             and field_sub on the card, the copy gather) on the ECDSA MOCK
             circuit (against the host MockProver, both timed; then the host
             MockProver's Python gate scan against the host engine's C
             gate-column check over the same columns, in turns, equal first
             rows) and on the
             pairing k=19 MOCK circuit of phase 6 (timed), both satisfied;
             each again with one advice value changed at a gated row (the
             failure named at that column and row); the golden circuit with
             a broken copy and a lookup value of 2^8 (both counted, equal to
             the plain version on the CPU).
9. gadgets - a Poseidon + SafeTypes circuit at k=9 (utils/testing.py
             poseidon_logic: hash_fix_len_bytes of 32 bytes,
             hash_var_len_bytes, a SafeBool and a SafeByte) through
             base_test().bench_builder on the card: keygen, the pinned
             prover builder, create_proof, verify_proof, a tampered proof
             rejected; vk and proof bytes equal to poseidon_k9.npz.
10. mesh   - (after 9, before 11) multi-device proving (parallel/): over the
             visible cards, or on one card a virtual mesh of its shards
             (printed): ShardedNTT at 2^15 and 2^17, forward, inverse and
             both coset forms, bit-equal to new_ntt / CosetNTT; sharded_msm
             of 2^15 SRS points equal to the single-device commit;
             create_proof(mesh=) of the golden (4 shards), RLC (2) and RAM
             (8) k=9 circuits byte-equal to their JAX goldens, and of the
             ECDSA k=15 circuit (4 shards, twice: runtime cold, then cached)
             with the JAX SHA-256, verifying, a flipped byte rejected; each
             mesh proof's stage seconds beside a single-device proof's; then
             a world of one (the HALO2_DIST_* triple, NCCL) whose
             make_global_mesh drives sharded_msm. The counts are reset just
             before each mesh proof and summed just after: the kernel rows'
             `launches_mesh`, ec_add (the shards' fold) and dft_stage (the
             sub-transforms of 2^6 points and more) among them.
11. mxu    - (after 10, before 5) the digit-plane DFT NTT (ops/ntt_mxu.py):
             dft_stage against its plain version at R, C in 8..256 with 1,
             3, 12 and 105 columns, without and with the pre and post
             diagonals; dft_ntt against its plain version at 2^6..2^11 with
             1, 3, 12 and 105 columns in four forms, one launch each;
             MxuNTT against NTT at 2^6..2^11 and FourStepNTT at 2^12, 2^15
             and 2^17 (forward, inverse, pre, post); MxuNTT timed
             against ntt_small at the k=9 paths' largest calls of each size
             and against FourStepNTT at 2^15 and 2^17 (turns old, mxu, mxu,
             old); dft_ntt launched, dft_stage and ntt_small not, in phases
             3, 3b and 9 (dft_ntt also in 10); the golden k=9 keygen and proof again
             with HALO2_NO_MXU_NTT=1 (new domains, every NTT through
             ntt_small) equal to golden_k9.npz.
12. msm    - (after 11, before 5) the reference's MSM benchmark circuit
             (configs/bn254/msm_circuit.t.config: k=13, batch 8, the serial
             MSM; msm_circuit.config: k=17, batch 100, window 4,
             multi_exp_par over many contexts), built as
             tests/test_configs.py:run_msm_config builds it: setup(k) on the
             card equal to the JAX host SRS, the MOCK builder's config
             params, break points, columns and copies equal to the JAX
             builder's (msm_digests.json), keygen, the pinned PROVER
             builder's witness, create_proof at seed 0, verify_proof and a
             tampered proof rejected; the vk and proof digests held where
             the JAX run froze them (both at k=13; at k=17 what
             make_goldens.py --msm reached). Stage seconds, peak device
             memory, copies, contexts and launches printed (the kernel rows'
             `launches_msm_k13`, `launches_msm_k17`; counts reset just
             before each); keygen's u16 packing through the host engine and
             again on the Python path, equal limbs, both timed. Then a k=12
             proof (the ECDSA circuit at k=12)
             with each switch: HALO2_NO_FOURSTEP_NTT=1 (MxuNTT on dft_stage
             for 2^12 and 2^14), with HALO2_NO_MXU_NTT=1 too (the radix-2
             stage loop of ntt_butterfly launches), HALO2_PROVER_SELFCHECK=1
             and =2, HALO2_PROVER_DEBUG=1 (keygen too): each proof's bytes
             equal the proof's without it; and the golden k=9 proof with the
             commit bound HALO2_COMMIT_SIMPLE_MAX=0 sets (Pippenger, not
             commit_dbl_add) equal to golden_k9.npz (the kernel rows'
             `launches_switches`: all these proofs). At its end the device
             memory allocated may exceed its start by 2 GiB at most, with no
             gc.collect(): its keys, runtimes and proofs are freed when their
             last reference goes. `--msm-only` builds the kernels, checks
             them (phase 2) and runs this phase alone.
13. api    - (after 12, before 5) the JAX package's standalone device API
             at the north star's sizes, the counts reset just before it and
             read just after (the kernel rows' `launches_api`): an MSM over
             2^20 distinct bases built on the card as s1[i % 256] + s2[(i >>
             8) % 256] + s3[i >> 16] (ec_add at [16, 2^20], then batch_inv:
             fermat_inv and the mont_mul prefix products) with random digits
             (window 13, 20 windows, distinct=False: bucket_sums_fused's
             complete add), through msm_device and DeviceCurve.msm (host
             points and ints), equal to the host's reference (the digits
             summed per group of points, 528 host scalar multiplications);
             3 warm runs (seconds, median points/s) and the stage split
             (CUDA events: lift, sort, bucket_sums_fused, bucket_weight,
             msm_combine), each run held to the host; FourStepNTT at 2^20
             bit-equal to NTT (the radix-2 stage loop of ntt_butterfly
             launches), at 2^22 (plan [2, 128, 128, 128]) a round trip and
             two outputs equal to host Horner values, median elems/s of 5
             warm runs each; at k = 15 every new Domain method on the card
             equal to the CPU's, eval_many_at to Horner,
             divide_by_vanishing(Z_H q) to q, DeviceField.pow timed;
             ParamsKZG.setup(15, seed) with its tau recomputed: commit ==
             p(tau) G, commit_lagrange == sum v_i L_i(tau) G, both ==
             commit_columns, commit_dev and commit_many; DeviceCurve.msm on
             tests/test_ec_device.py's 64-point duplicate/identity case ==
             the host. Every kernel of API_KERNELS must have launched.
5. timing  - every kernel again, at the largest shapes the main path gave it
             (the ECDSA, k=15 and k=9 paths' shapes; g1_batch_mul at phase
             6's [16, 2^20] with setup(19)'s scalars, its plain version run
             once, affine-equal to the old double-and-add kernel
             (g1_chain_bench), which is timed in turns with it, its bound
             beside the comb's; ntt_butterfly, ec_madd,
             ec_double, ec_add and bucket_scan, off the path, at the shapes
             they had on it before their fusion; ntt_small at the k=9 coset
             transform it served before MxuNTT, dft_stage at that
             transform's stage 1; dft_ntt in turns with the three launches
             it replaced, as CUDA events and as CUDA graphs):
             kernel time, plain version time and the bound, as one JSON line
             (dft_stage's library_ms: torch._int_mm at its pair products'
             GEMM shape, the product without the fold);
             the fused kernels' and fermat_inv's serial chains on [timing]
             lines, commit_dbl_add also at m = 1024, and ntt_small beside
             the per-stage composition it replaced, at the same shape; then
             every kernel whose largest launch in the k=17 MSM run does more
             work than that shape again at the MSM run's shape (the rows'
             `at_msm_k17`: bucket_sums_fused at its windows x 2^17 points,
             colntt at 2^19, ...); and every kernel of API_KERNELS at its
             largest launch of phase 13 (`at_api`: bucket_sums_fused at 20
             windows x 2^20 points with the complete add, ec_add at [16,
             2^20], ntt_butterfly at the 2^20 stage loop's halves, ...), and
             colntt at the 2^22 plan's first level (`at_api_a2`: A = 2, B =
             2^21).
5b. MSM    - one whole MSM at the ECDSA advice commit's shape (21 columns x
             2^15 points, window 10, distinct bases), in turns old, new, new,
             old: "old" accumulates the buckets by the bucket_scan composition
             (grouped as before, 91 windows a group), "new" is
             msm_many_device (bucket_sums_fused); both end in the fused tail
             and must give the same bucket sums and Jacobian points. Whole-MSM
             milliseconds and each stage's (CUDA events: sort, gather, scan,
             carry, pick; or sort, pack, fused) per turn; then the step-loop
             tail (the loop of single point ops) against the fused one
             (equal points, both timed), ec_add at [16, 139776], and the
             Montgomery product alone: a
             chain of dependent products per thread with the carry-chain
             product and with the 64-bit C one it replaced (products/s of
             each, in turns, outputs equal).

The last line is {"ok": true, "device": {...}}. Without a CUDA device the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import random
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and the 32-bit scalar
# rate outside the tensor cores (the 67 TFLOP/s float32 line, also used for
# 32-bit integer multiply-adds: a lower bound on their time).
PEAK_BYTES = 3.35e12
PEAK_OPS32 = 67e12
# the dense int8 tensor-core rate, 1979 T operations/s: multiply-adds per second
PEAK_MACS8 = 1979e12 / 2
# 32-bit operations of one Montgomery product (CIOS, 8 x 32-bit words):
# 136 partial products, each a low and a high multiply-add.
MM_OPS = 2 * 136
SOURCES = {
    "mont_mul": ("csrc/field_kernels.cu", "halo2_lib_tpu/ops/pallas_field.py:300"),
    "field_add": ("csrc/field_kernels.cu", "halo2_lib_tpu/ops/pallas_field.py:817"),
    "field_sub": ("csrc/field_kernels.cu", "halo2_lib_tpu/ops/pallas_field.py:822"),
    "fermat_inv": ("csrc/fermat_kernel.cu", "halo2_lib_tpu/ops/pallas_field.py:755"),
    "ntt_butterfly": ("csrc/ntt_kernels.cu", "halo2_lib_tpu/ops/pallas_field.py:708"),
    # every stage of a small transform: the stage loop of _butterfly_kernel
    # calls and the coset / 1/n scalings around it
    "ntt_small": ("csrc/ntt_kernels.cu", "halo2_lib_tpu/ops/pallas_field.py:708"),
    "colntt": ("csrc/ntt_kernels.cu", "halo2_lib_tpu/ops/ntt4.py:67"),
    "ec_add": ("csrc/ec_kernels.cu", "halo2_lib_tpu/ops/pallas_field.py:304"),
    "ec_double": ("csrc/ec_kernels.cu", "halo2_lib_tpu/ops/pallas_field.py:448"),
    "ec_madd": ("csrc/ec_kernels.cu", "halo2_lib_tpu/ops/pallas_field.py:430"),
    "bucket_scan": ("csrc/ec_kernels.cu", "halo2_lib_tpu/ops/pallas_field.py:620"),
    # the bucket accumulation with its lane-carry scan, pick and fix
    # (ec_device.py:463-591 around _bucket_scan_kernel)
    "bucket_sums_fused": ("csrc/ec_kernels.cu", "halo2_lib_tpu/ops/pallas_field.py:620"),
    # the fused MSM tail: the lax.scan / fori_loop bodies of single
    # _ec_add_kernel / _ec_double_kernel calls at ec_device.py:624-688
    "bucket_weight": ("csrc/ec_kernels.cu", "halo2_lib_tpu/ops/pallas_field.py:304"),
    "msm_combine": ("csrc/ec_kernels.cu", "halo2_lib_tpu/ops/pallas_field.py:448"),
    # the small-column commit: the lax.scan of _ec_double_kernel and
    # _ec_madd_kernel steps and the _ec_add_kernel lane tree
    "commit_dbl_add": ("csrc/ec_kernels.cu", "halo2_lib_tpu/ops/pallas_field.py:430"),
    # the SRS setup's scan of _ec_double_kernel and _ec_add_kernel steps
    "g1_batch_mul": ("csrc/ec_kernels.cu", "halo2_lib_tpu/ops/pallas_field.py:448"),
    # no pallas_call: one stage of the XLA module ntt_mxu.py (_stage_limbs
    # and _fold_mod_p)
    "dft_stage": ("csrc/dft_kernels.cu", "halo2_lib_tpu/ops/ntt_mxu.py:341"),
    # no pallas_call: a whole base transform of the XLA module ntt_mxu.py
    # (_transform's two stages, the twiddle and the transpose)
    "dft_ntt": ("csrc/dft_kernels.cu", "halo2_lib_tpu/ops/ntt_mxu.py:256"),
}
# kernels the main path no longer launches: (work, shape) as LARGEST kept
# them on the last path that ran them (ECDSA for bucket_scan, k=9 for the
# single point ops and the butterfly)
OFF_PATH_SHAPES = {
    "ntt_butterfly": (0, ((12, 16, 1024), (16, 1024))),
    "bucket_scan": (0, ((91, 128, 16, 256), True)),
    "ec_add": (0, ((8, 16, 256),)),
    "ec_double": (0, ((8, 16, 512),)),
    "ec_madd": (0, ((8, 16, 512), (16, 512), False)),
}
FUSES = {
    "ntt_small": "halo2_lib_tpu/ops/ntt.py:159-245, halo2_lib_tpu/ops/ntt.py:315-323",
    "bucket_sums_fused": "halo2_lib_tpu/ops/ec_device.py:463-591",
    "bucket_weight": "halo2_lib_tpu/ops/ec_device.py:624-674",
    "msm_combine": "halo2_lib_tpu/ops/ec_device.py:676-688",
    "commit_dbl_add": "halo2_lib_tpu/backend/kzg.py:499-519, halo2_lib_tpu/ops/ec_device.py:308",
    "g1_batch_mul": "halo2_lib_tpu/backend/kzg.py:635-661",
    "dft_stage": "halo2_lib_tpu/ops/ntt_mxu.py:341-377 (_stage_limbs), :97-186 (_fold_mod_p), "
                 ":256-289 (the twiddle and 1/n products)",
    "dft_ntt": "halo2_lib_tpu/ops/ntt_mxu.py:256-289 (_transform: both stages, the twiddle, "
               "the transpose, the diagonals), :341-377 (_stage_limbs), :97-186 (_fold_mod_p)",
}
# kernels timed at a shape other than their largest launch of this run:
# ntt_small at the k=9 coset transform it served until MxuNTT took those
# sizes (its launches now come from the mesh's 2^4 and 2^5 sub-transforms);
# dft_stage at the stage 1 of that transform, which it served until dft_ntt
# took every base transform up to 2^11 (it runs only where MxuNTT is built
# directly above that: phase 11)
COMPARE_SHAPES = {"ntt_small": ((12, 16, 2048), True, 0),
                  "dft_stage": ((12, 16, 64, 32), 64, True, 64 * 32)}
# the kernels the API phase (13) must launch: the general MSM over 2^20
# bases, the bases' build and normalisation, the NTT at 2^20 and 2^22, the
# Domain API
API_KERNELS = ("bucket_sums_fused", "bucket_weight", "msm_combine", "ec_add", "fermat_inv",
               "mont_mul", "field_add", "field_sub", "colntt", "ntt_butterfly")
# 32-bit operations of one batch of the inversion (csrc/fermat_kernel.cu):
# the 2x2 matrix on (d, e), 6 multiply-adds a limb with the multiple of p,
# and on (f, g), 4 a limb, over 9 limbs, each a 32 x 32 -> 64-bit product
# (a low and a high half); and 30 divsteps of about 10 operations.
INV_BATCH_OPS = 2 * 9 * (6 + 4) + 10 * 30


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return smi[0] if smi else "nvidia-smi: no output"


def log(msg: str) -> None:
    print(msg, flush=True)


def packed_both_ways(prover_mod, native, np, fn, python: bool = False):
    """Run fn() with backend/prover.py's _u16_cols recording each call (its
    columns, packing and seconds); then pack every recorded call again the
    other way (on the Python path if fn ran the host engine, through the
    engine if fn ran inside native.python_path, as `python` says) and
    require the same limbs. Returns fn's result and, per call, (columns,
    rows, engine seconds, Python-path seconds)."""
    calls, pack = [], prover_mod._u16_cols

    def recorded(cols, n):
        t = time.time()
        out = pack(cols, n)
        calls.append((cols, n, out, time.time() - t))
        return out

    prover_mod._u16_cols = recorded
    try:
        result = fn()
    finally:
        prover_mod._u16_cols = pack
    rows = []
    with contextlib.nullcontext() if python else native.python_path():
        for cols, n, out, secs in calls:
            t = time.time()
            again = pack(cols, n)
            t_again = time.time() - t
            if not np.array_equal(again, out):
                raise AssertionError(f"_u16_cols of {len(cols)} x {n}: the host engine's "
                                     "packing differs from the Python path's")
            rows.append((len(cols), n, *((t_again, secs) if python else (secs, t_again))))
    return result, rows


def rand_limbs(gen, shape, torch, p: int):
    """Random canonical field elements below p (limb-major int32)."""
    x = torch.randint(0, 1 << 16, shape, generator=gen, dtype=torch.int32, device="cuda")
    x[..., 15, :] %= p >> 240  # top limb below p's: value < p
    return x


def special_lanes(S, cf, torch):
    """Random Jacobian coordinates S (three [.., 16, B]) with, every seven
    lanes, an identity (Z = 0), a copy of the lane before (equal points: the
    doubling branch of a complete add or of an MSM row chain) and a negation
    of it (P + (-P))."""
    X, Y, Z = (t.clone() for t in S)

    def from_lane_before(t, src, lane):
        n = t[..., lane::7].shape[-1]
        t[..., lane::7] = src[..., lane - 1 :: 7][..., :n]

    Z[..., 3::7] = 0
    for t in (X, Y, Z):
        from_lane_before(t, t, 5)
    negY = cf.field_sub_plain(cf.FQ, torch.zeros_like(Y), Y)
    from_lane_before(X, X, 2)
    from_lane_before(Z, Z, 2)
    from_lane_before(Y, negY, 2)
    return X, Y, Z


def combine_specials(T, W: int, c: int, cf, torch):
    """In place: column 0 of the window sums T ([16, C * W], lane = column *
    W + w) meets res == T_{W-2} after its c doublings (the doubling branch);
    the last column, where C > 1, res == -T_{W-2} (the identity)."""
    C = T[0].shape[-1] // W
    top = tuple(t[:, W - 1 : W] for t in T)
    D = top
    for _ in range(c):
        D = cf.ec_double_plain(D)
    negD = (D[0], cf.field_sub_plain(cf.FQ, torch.zeros_like(D[1]), D[1]), D[2])
    for t, p, d, nd in zip(T, top, D, negD):
        t[:, W - 2 : W - 1] = d
        if C > 1:
            t[:, C * W - 1 : C * W] = p
            t[:, C * W - 2 : C * W - 1] = nd


class Stages:
    """CUDA-event stage timer: mark(name) closes the stage that began at the
    previous mark; ms() reads them after a synchronize."""

    def __init__(self, torch):
        self.torch = torch
        self.events = [(None, self._record())]

    def _record(self):
        e = self.torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def mark(self, name: str) -> None:
        self.events.append((name, self._record()))

    def ms(self) -> dict:
        self.torch.cuda.synchronize()
        out = {}
        for (_, a), (name, b) in zip(self.events, self.events[1:]):
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


def divsteps_needed(x: int, p: int) -> int:
    """Divsteps the inversion kernel runs on x before g = 0 (one at a time on
    whole integers, eta = -delta from -1, as the kernel starts)."""
    eta, f, g, n = -1, p, x, 0
    while g:
        if g & 1:
            if eta < 0:
                eta, f, g = -eta, g, -f
            g += f
        g >>= 1
        eta -= 1
        n += 1
    return n


def old_commit_double_and_add(cf, dc, scalars, Ax, Ay):
    """backend/kzg.py:commit_double_and_add before the fusion, on canonical
    scalars [C, 16, m]: the 254 one-bit windows MSB first, per bit one
    ec_double and one ec_madd launch (with its doubling branch) over all C
    * m lanes and a select, then DeviceCurve.tree_reduce (ec_add launches)
    -> Jacobian [16, C]."""
    C, _, m = scalars.shape
    Am = (Ax[:, :m].contiguous(), Ay[:, :m].contiguous())
    acc = dc.identity((C, m), scalars.device)
    for b in range(253, -1, -1):
        bit = ((scalars[:, b // 16, :] >> (b % 16)) & 1) != 0
        acc = cf.ec_double(acc)
        acc = dc.select(bit, cf.ec_madd(acc, Am, False), acc)
    X, Y, Z = dc.tree_reduce(acc)  # [C, 16, 1]
    return tuple(t[..., 0].transpose(0, 1) for t in (X, Y, Z))


def ntt_chain(spec) -> tuple[int, int]:
    """(products a thread of ntt_small runs, its dependent chain) at spec:
    4 elements a thread, so 2 butterflies a stage, and the diagonal
    products of its 4 elements."""
    (_, _, n), with_pre, post_n = spec
    logn = n.bit_length() - 1
    diag = int(with_pre) + int(post_n > 0)
    return 2 * logn + 4 * diag, logn + diag


def commit_case(gen, torch, cf, spec, P: dict):
    """Inputs of commit_dbl_add at spec ((C, 16, m), (16, n)): random
    canonical Fr scalars and Fq bases (the formulas need no curve points to
    agree with their plain version); lanes 0-2 of column 0 hold the scalars
    0, 1 and r - 1, the last column of three or more is all zeros (its sum
    the identity), and base 3 is (0, 0)."""
    (C, _, m), (_, n) = spec
    scal = rand_limbs(gen, (C, 16, m), torch, P[cf.FR])
    r = P[cf.FR]
    for lane, v in enumerate((0, 1, r - 1)[:m]):
        scal[0, :, lane] = torch.tensor([(v >> (16 * i)) & 0xFFFF for i in range(16)],
                                        dtype=torch.int32, device="cuda")
    if C >= 3:
        scal[C - 1] = 0
    Ax, Ay = (rand_limbs(gen, (16, n), torch, P[cf.FQ]) for _ in range(2))
    if m > 3:
        Ax[:, 3] = Ay[:, 3] = 0
    return scal, Ax, Ay


def chain_work(scalars) -> list[int]:
    """Montgomery products of each lane's double-and-add chain (the chain
    launch of commit_dbl_add, and of g1_batch_mul before the comb): a
    doubling (7) at and below the lane's top bit and a mixed add (11) at each
    set bit but the first (which meets the identity)."""
    return [7 * x.bit_length() + 11 * max(bin(x).count("1") - 1, 0) for x in scalars]


def comb_work(cf, torch, scalars) -> tuple[int, int]:
    """(Montgomery products g1_batch_mul's comb runs on the [16, n] scalar
    limbs, the longest lane's): a mixed add (11) at each nonzero signed
    digit of a lane (cf.comb_digits) but the first, which meets the
    identity."""
    nz = sum((mag > 0).to(torch.int64) for mag, _ in cf.comb_digits(scalars.to(torch.int64)))
    lane = 11 * (nz - 1).clamp(min=0)
    return int(lane.sum()), int(lane.max())


def ptxas_report(log: str, names) -> dict:
    """Registers and spill bytes of each kernel whose mangled name holds one
    of `names`, from ptxas -v output: {name: [(registers, spill stores,
    spill loads), ...]} (one entry per instantiation)."""
    out, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur, spill = next((k for k in names if k in line), None), (-1, -1)
        elif cur and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            spill = (nums[1], nums[2]) if len(nums) >= 3 else (-1, -1)
        elif cur and "Used" in line and "registers" in line:
            regs = int(line.split("Used")[1].split()[0])
            out.setdefault(cur, []).append((regs, *spill))
            cur = None
    return out


def commit_work(scalars, m: int):
    """(Montgomery products commit_dbl_add runs on these scalars, the longest
    thread's chain of them): each lane's chain_work, then m - 1 complete
    adds (16) per column, log2(m) levels."""
    lane = chain_work(scalars)
    C = len(scalars) // m
    levels = (m - 1).bit_length()
    return sum(lane) + 16 * C * (m - 1), max(lane) + 16 * levels


def old_seg_scan(cf, torch, X, Y, Z, flag, width: int):
    """The lane-carry scan before the fusion: Hillis-Steele levels of single
    ec_add launches and torch rolls and selects (ops/ec_device.py before
    the fusion)."""
    idx = torch.arange(X.shape[-1], device=X.device) % width
    x, y, z, f = X, Y, Z, flag
    for d in range((width - 1).bit_length()):
        shift = 1 << d
        px, py, pz = (torch.roll(t, shift, dims=-1) for t in (x, y, z))
        pf = torch.roll(f, shift, dims=-1)
        s = cf.ec_add((x, y, z), (px, py, pz))
        use = (~f) & (idx >= shift)
        x, y, z = (torch.where(use[..., None, :], a, b) for a, b in zip(s, (x, y, z)))
        f = f | (use & pf) | (idx < shift)
    return x, y, z


def old_group_bucket_sums(cf, torch, A, order, d_sorted, nbuckets: int, distinct: bool, CL: int,
                          st=None):
    """The bucket accumulation before the fusion (ops/ec_device.py,
    _group_bucket_sums before the fusion): the packed gather of the bases into the
    [Wb, R, 16, CL] scan layout, one bucket_scan launch writing every step,
    the lane-carry scan, the binary-search pick of each bucket's last slot
    and one ec_add for the buckets whose run began in an earlier lane. `st`
    (a Stages) marks gather, scan, carry and pick."""
    Ax, Ay = A
    dev = Ax.device
    Wb, n = d_sorted.shape
    R = n // CL
    mark = st.mark if st is not None else (lambda name: None)
    order, d_sorted = order.to(torch.int64), d_sorted.to(torch.int64)
    seg_start = torch.cat(
        [torch.ones((Wb, 1), dtype=torch.bool, device=dev), d_sorted[:, 1:] != d_sorted[:, :-1]],
        dim=1,
    )
    live = d_sorted > 0

    def pack_pairs(t):
        v = t[:8].to(torch.int64) | (t[8:].to(torch.int64) << 16)
        return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)

    Axy = torch.cat([pack_pairs(Ax), pack_pairs(Ay)], dim=0)
    order_perm = order.reshape(Wb, CL, R).transpose(1, 2)
    g = Axy[:, order_perm.reshape(-1)].reshape(16, Wb, R, CL)
    live_perm = live.reshape(Wb, CL, R).transpose(1, 2)
    g = torch.where(live_perm[None], g, torch.zeros_like(g))
    axy = g.permute(1, 2, 0, 3).contiguous()
    sst = seg_start.reshape(Wb, CL, R).transpose(1, 2).to(torch.int32).contiguous()
    mark("gather")
    out = cf.bucket_scan(axy, sst, distinct)
    mark("scan")
    last = out[:, R - 1]
    lastv = tuple(last[:, 16 * i : 16 * (i + 1), :] for i in range(3))
    has_start = seg_start.reshape(Wb, CL, R).any(dim=2)
    lastm = tuple(t.transpose(0, 1).reshape(16, Wb * CL) for t in lastv)
    cm = old_seg_scan(cf, torch, *lastm, has_start.reshape(Wb * CL), CL)
    zero = torch.zeros((Wb, 16, 1), dtype=torch.int32, device=dev)
    cx, cy, cz = (
        torch.cat([zero, t.reshape(16, Wb, CL).transpose(0, 1)[..., :-1]], dim=-1) for t in cm
    )
    mark("carry")
    targets = torch.arange(1, nbuckets + 1, device=dev, dtype=d_sorted.dtype)
    targets = targets.expand(Wb, nbuckets).contiguous()
    last_idx = torch.searchsorted(d_sorted, targets, right=True) - 1
    first_idx = torch.searchsorted(d_sorted, targets, right=False)
    present = last_idx >= first_idx
    safe_idx = last_idx.clamp(0, n - 1)
    lane = safe_idx // R
    idx_r = safe_idx % R
    cols = torch.arange(48, device=dev)
    lin = (idx_r[:, None, :] * 48 + cols[None, :, None]) * CL + lane[:, None, :]
    vals = torch.gather(out.reshape(Wb, R * 48 * CL), 1, lin.reshape(Wb, -1))
    vals = vals.reshape(Wb, 48, nbuckets)
    bX, bY, bZ = vals[:, :16], vals[:, 16:32], vals[:, 32:]
    wi, bi = torch.nonzero(first_idx < lane * R, as_tuple=True)
    li = lane[wi, bi]
    fixed = cf.ec_add(
        tuple(t[wi, :, bi].T for t in (bX, bY, bZ)),
        tuple(t[wi, :, li].T for t in (cx, cy, cz)),
    )
    bX, bY, bZ = (t.clone() for t in (bX, bY, bZ))
    for t, f in zip((bX, bY, bZ), fixed):
        t[wi, :, bi] = f.T
    bZ = torch.where(present[:, None, :], bZ, torch.zeros_like(bZ))
    mark("pick")
    return bX, bY, bZ


def old_bucket_sums(cf, torch, A, digits, window_bits: int, distinct: bool, CL: int, st=None):
    """ops/ec_device.py:bucket_sums before the fusion: one sort, then groups of
    windows within 2^22 point-slots (91 windows a group at n = 2^15)."""
    C, W, n = digits.shape
    nbuckets = (1 << window_bits) - 1
    flat = digits.reshape(C * W, n).to(torch.int64)
    d_sorted, order = torch.sort(flat, dim=1, stable=True)
    if st is not None:
        st.mark("sort")
    Wtot = C * W
    divs = [g for g in range(1, Wtot + 1) if Wtot % g == 0 and g * n <= 1 << 22]
    good = [g for g in divs if g % 4 == 0] or divs or [1]
    group = Wtot if Wtot * n <= 1 << 22 else max(good)
    parts = [
        old_group_bucket_sums(cf, torch, A, order[i : i + group], d_sorted[i : i + group],
                              nbuckets, distinct, CL, st)
        for i in range(0, Wtot, group)
    ]
    return tuple(torch.cat([p[j] for p in parts], dim=0) for j in range(3))


def bucket_case(gen, torch, cf, spec, p: int, special: bool):
    """Inputs of bucket_sums_fused at spec ((Wtot, n), (npts, 16), lanes,
    nbuckets, distinct): random canonical Fq bases (point-major words) and
    random window digits, sorted. With `special`, windows 0-5 hold: bases 0
    and 1 (equal: P + P) alone in bucket 5; bases 0 and 2 (P, -P) alone in
    bucket 6; every digit 0; one bucket everywhere; a run of n/2 slots in
    bucket 1 between digits >= 3; no digit below 4. Returns (args, A) with A
    the limb-major affine bases."""
    (Wtot, n), (npts, _), lanes, nb, distinct = spec
    Ax, Ay = (rand_limbs(gen, (16, npts), torch, p) for _ in range(2))
    digits = torch.randint(0, nb + 1, (Wtot, n), generator=gen, device="cuda", dtype=torch.int32)
    if special:
        Ax[:, 1], Ay[:, 1] = Ax[:, 0], Ay[:, 0]
        Ax[:, 2] = Ax[:, 0]
        Ay[:, 2:3] = cf.field_sub_plain(cf.FQ, torch.zeros_like(Ay[:, :1]), Ay[:, :1])
        digits[0][digits[0] == 5] = 4
        digits[0, :2] = 5
        digits[1][digits[1] == 6] = 7
        digits[1, 0] = digits[1, 2] = 6
        digits[2] = 0
        digits[3] = min(nb, 7)
        digits[4] = torch.where(digits[4] < 3, 3, digits[4])
        digits[4, n // 4 : 3 * n // 4] = 1
        digits[5] = torch.clamp(digits[5], min=min(nb, 4))
    d_sorted, order = torch.sort(digits, dim=1, stable=True)
    return (cf.pack_bases(Ax, Ay), order.to(torch.int32), d_sorted, lanes, nb, distinct), (Ax, Ay)


def ntt_input_limbs(log_n: int, np, cols: int = 2):
    """make_goldens.ntt_inputs(log_n, cols) as canonical 16-bit limbs
    int32[cols, 16, n], vectorized: each value is four 63-bit words, word i
    at bit 63 i (below 2^252 < r, so no reduction)."""
    n = 1 << log_n
    rng = np.random.default_rng(1000 + log_n)
    words = rng.integers(0, 1 << 63, size=(cols, n, 4), dtype=np.int64)
    bits = np.unpackbits(words.astype("<u8").view(np.uint8).reshape(cols, n, 4, 8), axis=-1,
                         bitorder="little")[..., :63].reshape(cols, n, 252)
    bits = np.concatenate([bits, np.zeros((cols, n, 4), np.uint8)], axis=-1)
    limbs = np.packbits(bits, axis=-1, bitorder="little").view("<u2")  # [cols, n, 16]
    return np.ascontiguousarray(limbs.transpose(0, 2, 1)).astype(np.int32)


def mesh_shards(torch, dev, S: int):
    """A mesh of S shards over the visible cards (shard s on card
    s * cards // S: one a card when there are S), or, on one card, a virtual
    mesh of S shards on it. Returns (mesh, description)."""
    from halo2_lib_tpu_torch.parallel.sharded import Mesh, make_mesh

    cards = torch.cuda.device_count()
    if cards >= S:
        return make_mesh(S), f"{S} cards"
    if cards > 1:
        devs = [torch.device("cuda", s * cards // S) for s in range(S)]
        return Mesh(devs, ("dp",)), f"{S} shards over {cards} cards"
    mesh = make_mesh(S, device=dev)
    return mesh, f"a virtual mesh of {S} shards on {mesh.devices[0]}"


def mesh_phase(torch, np, dev, keys=None):
    """Phase 10 (see the module docstring): the sharded NTT and MSM against
    the single-device ones, the k=9 golden, RLC and RAM circuits and the
    ECDSA k=15 circuit proved over meshes (stage seconds beside the
    single-device proof's), and a world-of-one process group driving the
    sharded MSM. keys: phases 3, 3b and 4b's (params9, pk9, {circuit: (pk,
    keygen builder)}, params15, epk, ebuilder, erng_state), or None to make
    them here. Returns the mesh proofs' launches and largest launches."""
    import torch.distributed as dist

    from halo2_lib_tpu_torch.backend.keygen import keygen
    from halo2_lib_tpu_torch.backend.kzg import ParamsKZG, host_points
    from halo2_lib_tpu_torch.backend.precompile import warm_prover
    from halo2_lib_tpu_torch.backend.prover import create_proof
    from halo2_lib_tpu_torch.backend.verifier import verify_proof
    from halo2_lib_tpu_torch.ops import cuda_field as cf
    from halo2_lib_tpu_torch.ops.limbs import DeviceField
    from halo2_lib_tpu_torch.ops.ntt import CosetNTT, new_ntt
    from halo2_lib_tpu_torch.parallel import sharded_msm
    from halo2_lib_tpu_torch.parallel.distributed import init_distributed, make_global_mesh
    from halo2_lib_tpu_torch.parallel.sharded import ShardedNTT
    from halo2_lib_tpu_torch.utils.fields import FR_BN254
    from halo2_lib_tpu_torch.utils.pinning import pinning_of
    from halo2_lib_tpu_torch.utils.testing import (
        ecdsa_circuit, ecdsa_inputs, ecdsa_witness, golden_circuit, ram_circuit, rlc_circuit,
        rlc_prover,
    )

    t10 = time.time()
    fr = DeviceField(FR_BN254)
    goldens = os.path.join(HERE, "tests", "data", "torch_goldens")
    with open(os.path.join(goldens, "ecdsa_k15.json")) as f:
        eref = json.load(f)
    if keys is None:
        params9 = ParamsKZG.read(os.path.join(HERE, "params", "kzg_bn254_9.srs"), device=dev)
        pk9 = keygen(params9, golden_circuit(), device=dev)
        keys3b = {}
        for cname, make in (("multiphase", rlc_circuit), ("dynlookup", ram_circuit)):
            b = make()
            keys3b[cname] = (keygen(params9, b, device=dev), b)
        params15 = ParamsKZG.read(os.path.join(HERE, "params", "kzg_bn254_15.srs"), device=dev)
        rng = random.Random(0x5EC0)
        ebuilder = ecdsa_circuit(15, 14, rng=rng)
        epk = keygen(params15, ebuilder, device=dev)
        erng_state = rng.getstate()
    else:
        params9, pk9, keys3b, params15, epk, ebuilder, erng_state = keys
    mesh4, desc4 = mesh_shards(torch, dev, 4)
    log(f"[mesh] meshes over {torch.cuda.device_count()} visible card(s): 4 shards as {desc4}")

    def sync():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    # the sharded four-step NTT against the single-device transforms
    gen = torch.Generator(device="cuda").manual_seed(10)
    for k in (15, 17):
        x = rand_limbs(gen, (2, 16, 1 << k), torch, FR_BN254.p)
        single, coset = new_ntt(fr, k, dev), CosetNTT(fr, k, 7, dev)
        sn, sc = ShardedNTT(fr, k, mesh4), ShardedNTT(fr, k, mesh4, shift=7)
        for label, got, want in (("forward", sn.forward(x), single.forward(x)),
                                 ("inverse", sn.inverse(x), single.inverse(x)),
                                 ("coset forward", sc.forward(x), coset.forward(x)),
                                 ("coset inverse", sc.inverse(x), coset.inverse(x))):
            if not torch.equal(got, want):
                raise AssertionError(f"ShardedNTT 2^{k} {label} differs from the single-device one")
        sync()
        t = time.time()
        sn.forward(x)
        sync()
        ms_mesh = 1e3 * (time.time() - t)
        t = time.time()
        single.forward(x)
        sync()
        log(f"[mesh] ShardedNTT 2^{k} (4 shards): forward, inverse, coset forward and inverse "
            f"bit-equal to new_ntt / CosetNTT; 2 columns forward {ms_mesh:.3f} ms, single device "
            f"{1e3 * (time.time() - t):.3f} ms (host clock)")

    # the sharded MSM at 2^15 points against the single-device commit
    n15 = params15.n
    srng = random.Random(15)
    scalars = [srng.randrange(FR_BN254.p) for _ in range(n15)]
    points = params15.g
    dc = params15.device_curve()
    t = time.time()
    got = sharded_msm(dc, points, scalars, mesh4)
    sync()
    t_sh = time.time() - t
    t = time.time()
    want = host_points(params15.commit_columns(fr, fr.pack(scalars, device=dev)[None],
                                               params15.affine_bases(dev)))[0]
    t_single = time.time() - t
    if got != want:
        raise AssertionError("sharded_msm at 2^15 points differs from the single-device commit")
    log(f"[mesh] sharded_msm of 2^15 SRS points (4 shards) == the single-device commit; "
        f"{t_sh:.3f}s with the host packing of the points, single-device commit {t_single:.3f}s")

    # create_proof over meshes: every proof against the JAX bytes, stage
    # seconds beside a single-device proof's (the counts reset just before
    # each mesh proof and read just after)
    launches = {k: 0 for k in cf.KERNELS}
    largest: dict = {}
    stages = []

    def mesh_prove(label, S, prove, check, single=True):
        """One mesh proof, checked, after a single-device one (unless
        `single` is False: that proof would replace the key's mesh runtime)."""
        mesh, desc = mesh_shards(torch, dev, S)
        st1, stm, t1 = {}, {}, None
        if single:
            sync()
            t = time.time()
            check(prove(None, st1))
            sync()
            t1 = time.time() - t
        sync()
        cf.reset_launches()
        t = time.time()
        proof = prove(mesh, stm)
        sync()
        tm = time.time() - t
        for k in cf.KERNELS:
            launches[k] += cf.LAUNCHES[k]
        for k, v in cf.LARGEST.items():
            if v[0] > largest.get(k, (0,))[0]:
                largest[k] = v
        check(proof)
        stages.append({"circuit": label, "shards": desc, "single_s": t1 and round(t1, 4),
                       "mesh_s": round(tm, 4), "single_stages_s": {k: round(v, 4) for k, v in st1.items()},
                       "mesh_stages_s": {k: round(v, 4) for k, v in stm.items()}})
        log(f"[mesh] {label} over {desc}: bytes equal the JAX golden; create_proof {tm:.3f}s "
            f"(single device {'not run' if t1 is None else f'{t1:.3f}s'}); stages (s) mesh "
            f"{json.dumps(stages[-1]['mesh_stages_s'])}, "
            f"single {json.dumps(stages[-1]['single_stages_s'])}")
        return proof

    def equal_to(npz):
        gold = np.load(os.path.join(goldens, npz))

        def check(proof):
            if proof != bytes(gold["proof"]):
                raise AssertionError(f"mesh proof differs from {npz}")
        return check

    def golden_prove(mesh, st):
        return create_proof(params9, pk9, golden_circuit(), seed=0, device=dev if mesh is None else None,
                            timings=st, mesh=mesh)

    def rlc_prove(mesh, st):
        pk, b = keys3b["multiphase"]
        pb, phase_fns = rlc_prover(pk, b.break_points())
        return create_proof(params9, pk, pb, seed=0, phase_fns=phase_fns,
                            device=dev if mesh is None else None, timings=st, mesh=mesh)

    def ram_prove(mesh, st):
        pk, _ = keys3b["dynlookup"]
        return create_proof(params9, pk, ram_circuit(), seed=0, device=dev if mesh is None else None,
                            timings=st, mesh=mesh)

    epin = pinning_of(ebuilder)

    def ecdsa_prove(mesh, st):
        r = random.Random()
        r.setstate(erng_state)
        pb = epin.prover_builder()
        ecdsa_witness(pb, ecdsa_inputs(), r)
        return create_proof(params15, epk, pb, seed=0, device=dev if mesh is None else None,
                            timings=st, mesh=mesh)

    def ecdsa_check(proof):
        if hashlib.sha256(proof).hexdigest() != eref["proof_sha256"]:
            raise AssertionError("ECDSA mesh proof sha256 differs from the JAX digest")

    mesh_prove("golden k=9", 4, golden_prove, equal_to("golden_k9.npz"))
    mesh_prove("RLC k=9 (phase_fns)", 2, rlc_prove, equal_to("multiphase_k9.npz"))
    mesh_prove("RAM k=9 (dynamic lookup)", 8, ram_prove, equal_to("dynlookup_k9.npz"))
    eproof = mesh_prove("ECDSA k=15", 4, ecdsa_prove, ecdsa_check)
    # the warm-up over the mesh keeps the runtime that proof built; the
    # ECDSA mesh proof again, its runtime cached on the key
    rt = epk._runtime
    t = time.time()
    ntasks = warm_prover(params15, epk, mesh=mesh4)
    if epk._runtime is not rt:
        raise AssertionError("warm_prover(mesh=) rebuilt the mesh runtime")
    log(f"[mesh] warm_prover(mesh=): {ntasks} tasks in {time.time() - t:.3f}s on the cached "
        f"mesh runtime")
    mesh_prove("ECDSA k=15, mesh runtime cached", 4, ecdsa_prove, ecdsa_check, single=False)
    if not verify_proof(params15, epk.vk, eproof):
        raise AssertionError("ECDSA mesh proof does not verify")
    bad = bytearray(eproof)
    bad[len(bad) // 2] ^= 1
    if verify_proof(params15, epk.vk, bytes(bad)):
        raise AssertionError("ECDSA mesh proof: a flipped byte verifies")
    log("[mesh] ECDSA k=15 mesh proof: sha256 == the JAX digest, verifies, a flipped byte is "
        "rejected")
    log("[mesh] the mesh proofs' launches: " + json.dumps(launches))
    for k in ("ec_add", "commit_dbl_add", "bucket_sums_fused", "ntt_small", "dft_ntt", "mont_mul"):
        if launches[k] == 0:
            raise AssertionError(f"mesh proofs: no {k} launch")

    # a world of one: init_distributed over NCCL, make_global_mesh driving
    # the sharded MSM
    env = {"HALO2_DIST_COORD": f"127.0.0.1:{free_port()}", "HALO2_DIST_NPROCS": "1",
           "HALO2_DIST_PROCID": "0"}
    os.environ.update(env)
    try:
        if not init_distributed():
            raise AssertionError("init_distributed did not join with the env triple set")
        backend = dist.get_backend()
        gmesh = make_global_mesh()
        got = sharded_msm(dc, points[:4096], scalars[:4096], gmesh)
        want = host_points(params15.commit_columns(fr, fr.pack(scalars[:4096], device=dev)[None],
                                                   params15.affine_bases(dev)))[0]
        if got != want:
            raise AssertionError("make_global_mesh's sharded_msm differs from the single commit")
        log(f"[mesh] world of one over {backend}: make_global_mesh {gmesh} drove sharded_msm of "
            f"4096 points == the single-device commit")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)
    log(json.dumps({"mesh_runs": stages}))
    log(f"[mesh] phase 10 {time.time() - t10:.2f}s")
    return launches, largest


def host_msm(points, scalars, q: int):
    """sum_i s_i P_i over bn254 G1 with exact host ints: one chain of
    Jacobian doublings shared by every term (Straus), a mixed add for each
    set bit, one inversion at the end; affine (x, y) or None."""

    def dbl(P):
        X, Y, Z = P
        if Z == 0 or Y == 0:
            return (1, 1, 0)
        A, B = X * X % q, Y * Y % q
        C = B * B % q
        D = 2 * ((X + B) * (X + B) - A - C) % q
        E = 3 * A % q
        X3 = (E * E - 2 * D) % q
        return (X3, (E * (D - X3) - 8 * C) % q, 2 * Y * Z % q)

    def madd(P, x2, y2):
        X, Y, Z = P
        if Z == 0:
            return (x2, y2, 1)
        ZZ = Z * Z % q
        H = (x2 * ZZ - X) % q
        r = (y2 * ZZ * Z - Y) % q
        if H == 0:
            return dbl(P) if r == 0 else (1, 1, 0)
        HH = H * H % q
        HHH, V = H * HH % q, X * HH % q
        X3 = (r * r - HHH - 2 * V) % q
        return (X3, (r * (V - X3) - Y * HHH) % q, Z * H % q)

    terms = [(pt, s) for pt, s in zip(points, scalars) if pt is not None and s]
    acc = (1, 1, 0)
    for bit in range(max((s.bit_length() for _, s in terms), default=0) - 1, -1, -1):
        acc = dbl(acc)
        for (x2, y2), s in terms:
            if s >> bit & 1:
                acc = madd(acc, x2, y2)
    X, Y, Z = acc
    if Z == 0:
        return None
    zi = pow(Z, -1, q)
    zi2 = zi * zi % q
    return (X * zi2 % q, Y * zi2 * zi % q)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> None:
    t_start = time.time()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, HERE)
    import numpy as np

    from halo2_lib_tpu_torch.backend.keygen import keygen
    from halo2_lib_tpu_torch.backend.poly import Domain, _domain
    from halo2_lib_tpu_torch.backend.kzg import (
        ParamsKZG, _affine_mont, _lagrange_scalars, _pack_affine, _tau_powers,
        commit_double_and_add, gen_srs, host_points, window_digits,
    )
    from halo2_lib_tpu_torch.backend.prover import create_proof
    from halo2_lib_tpu_torch.backend.verifier import verify_proof
    from halo2_lib_tpu_torch.ops import cuda_field as cf
    from halo2_lib_tpu_torch.ops import ec_device as ec_mod
    from halo2_lib_tpu_torch.ops.ec_device import (
        DeviceCurve, _scan_lanes, msm_device, msm_many_device, msm_window_bits, weight_lanes,
    )
    from halo2_lib_tpu_torch.ops.limbs import DeviceField, ints_to_limbs_T, limbs_to_ints
    from halo2_lib_tpu_torch.ops.ntt import NTT, CosetNTT, FourStepNTT, new_ntt, ntt_stages
    from halo2_lib_tpu_torch.ops.ntt_mxu import MxuNTT, dft_planes_np
    from halo2_lib_tpu_torch.utils.chacha import reference_srs_tau
    from halo2_lib_tpu_torch.backend import kzg as kzg_mod
    from halo2_lib_tpu_torch.backend.kzg import COMMIT_SIMPLE_MAX
    from halo2_lib_tpu_torch.ecc import ec as port_ec
    from halo2_lib_tpu_torch.utils.curves import BN254_G1
    from halo2_lib_tpu_torch.utils.fields import FQ_BN254, FR_BN254
    from halo2_lib_tpu_torch.backend.mock import MockProver, gate_failures
    from halo2_lib_tpu_torch.backend.mock_device import DeviceMockProver
    from halo2_lib_tpu_torch.backend.pipeline import Phase0Pipeline
    from halo2_lib_tpu_torch.backend.precompile import warm_prover
    from halo2_lib_tpu_torch.utils.pinning import Pinning, pinning_of
    from halo2_lib_tpu_torch.utils.testing import (
        POSEIDON_K, POSEIDON_LOOKUP_BITS, base_test, check_proof, ecdsa_circuit, ecdsa_inputs,
        ecdsa_witness, golden_circuit, golden_witness, pairing_circuit, pairing_inputs,
        pairing_witness, poseidon_inputs, poseidon_logic, ram_circuit, rlc_circuit, rlc_prover,
        slice_circuit, comb_edge_scalars, old_g1_batch_mul, MSM_CONFIG, MSM_T_CONFIG, load_config,
        msm_circuit, msm_witness, circuit_digests,
    )

    dev = torch.device("cuda")
    P = {cf.FR: FR_BN254.p, cf.FQ: FQ_BN254.p}
    fr_df = DeviceField(FR_BN254)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    # --- 1. build ---------------------------------------------------------------
    t = time.time()
    cf.build()
    log(f"[build] kernels built in {time.time() - t:.2f}s; load {cf.load():.3f}s")
    if "--ptxas" in sys.argv:
        log(cf.ptxas_log())
    # registers and spill bytes of the redesigned kernels and the ones they
    # replaced, from the report the build keeps beside the library
    ptxas = ptxas_report(cf.ptxas_log(), ("g1_fixed_mul_k", "commit_chain_k", "dft_ntt_k",
                                          "dft_stage"))
    if "g1_fixed_mul_k" not in ptxas or "dft_ntt_k" not in ptxas:
        raise AssertionError(f"ptxas's report names no g1_fixed_mul_k or dft_ntt_k: {ptxas}")
    log("[build] ptxas (registers, spill stores, spill loads) per instantiation: "
        + json.dumps(ptxas))

    # --- 1b. the host witness engine (csrc/host_engine.c) from a clean build --------------------
    from halo2_lib_tpu_torch import native
    from halo2_lib_tpu_torch.backend import prover as prover_mod

    stale = [f for f in os.listdir(native.BUILD_DIR) if f.startswith(native.MODULE + "_")]
    for f in stale:
        os.remove(os.path.join(native.BUILD_DIR, f))
    t = time.time()
    so = native.build()
    t_cc = time.time() - t
    engine = native.get_native()
    if (engine is None or engine.__name__ != native.MODULE
            or os.path.dirname(engine.__file__) != native.BUILD_DIR
            or native.get_emitter(FR_BN254.p) is None or native.get_region_mod() is not engine):
        raise AssertionError(f"[engine] the host witness engine is not loaded: {engine}")
    log(f"[engine] csrc/host_engine.c built by cc in {t_cc:.2f}s (earlier builds removed "
        f"first: {len(stale)}) and loaded as {engine.__name__} from "
        f"{os.path.relpath(so, HERE)}; the gate chips' emitter and the region hook hold it")
    if "--mesh-only" in sys.argv:
        # phase 10 alone, over every visible card (the multi-card check)
        mesh_phase(torch, np, dev)
        log(f"[total] chip_smoke.py --mesh-only {time.time() - t_start:.1f}s")
        return

    # --- kernel calls on given inputs (kernel and plain) -------------------------
    def make_inputs(name: str, spec):
        """Random inputs for kernel `name` at shapes `spec` (LARGEST's
        shapes)."""
        if name in ("mont_mul", "field_add", "field_sub"):
            (sa, sb), fid = spec, cf.FR
            return fid, (rand_limbs(gen, sa, torch, P[fid]), rand_limbs(gen, sb, torch, P[fid]))
        if name == "fermat_inv":
            (sa,) = spec
            return cf.FR, (rand_limbs(gen, sa, torch, P[cf.FR]),)
        if name == "commit_dbl_add":
            return cf.FQ, commit_case(gen, torch, cf, spec, P)
        if name == "g1_batch_mul":
            # the scalars of phase 6's setup(19): tau^i, then L_i(tau)
            sc = torch.from_numpy(ints_to_limbs_T(taus19 + lag19).astype(np.int32)).to(dev)
            return cf.FQ, (sc, *dcq.pack_points_affine([BN254_G1.g], dev))
        if name == "ntt_butterfly":
            sa, sw = spec
            a = rand_limbs(gen, sa, torch, P[cf.FR])
            return cf.FR, (a, rand_limbs(gen, sa, torch, P[cf.FR]), rand_limbs(gen, sw, torch, P[cf.FR]))
        if name == "ntt_small":
            # the NTT's own table (inverse where a post diagonal is given)
            (C, _, n), with_pre, post_n = spec
            tw = NTT(fr_df, n.bit_length() - 1, dev).tw[post_n == 0]
            x = rand_limbs(gen, (C, 16, n), torch, P[cf.FR])
            pre = rand_limbs(gen, (16, n), torch, P[cf.FR]) if with_pre else None
            post = rand_limbs(gen, (16, post_n), torch, P[cf.FR]) if post_n else None
            return cf.FR, (x, tw, pre, post)
        if name == "dft_stage":
            # the R-point DFT's planes, and diagonals of the shapes given
            (L, _, R, C), Ro, with_pre, post_n = spec
            root = FR_BN254.nth_root_of_unity(R.bit_length() - 1)
            planes = torch.from_numpy(dft_planes_np(P[cf.FR], root, R)).to(dev)
            # (made limb-major with the lanes flat: rand_limbs takes the
            # limb axis at -2)
            x = rand_limbs(gen, (L, 16, R * C), torch, P[cf.FR]).reshape(L, 16, R, C)
            pre = (rand_limbs(gen, (16, R * C), torch, P[cf.FR]).reshape(16, R, C)
                   if with_pre else None)
            post = (None if not post_n else rand_limbs(gen, (16, post_n), torch, P[cf.FR])
                    .reshape((16, 1) if post_n == 1 else (16, Ro, C)))
            return cf.FR, (x, planes, pre, post)
        if name == "dft_ntt":
            # MxuNTT's own tables for the length (inverse where a post
            # diagonal is given), random diagonals of the shapes given
            (L, _, n), with_pre, post_n = spec
            mxu_c = MxuNTT(fr_df, n.bit_length() - 1, dev)
            tw, w1, w2 = mxu_c._consts[post_n == 0]
            x = rand_limbs(gen, (L, 16, n), torch, P[cf.FR])
            pre = rand_limbs(gen, (16, n), torch, P[cf.FR]) if with_pre else None
            post = rand_limbs(gen, (16, post_n), torch, P[cf.FR]) if post_n else None
            return cf.FR, (x, w1, w2, tw, pre, post)
        if name == "colntt":
            (L, A, _, B), with_mid = spec
            x = rand_limbs(gen, (L, A, 16, B), torch, P[cf.FR])
            tw = rand_limbs(gen, (16, A // 2), torch, P[cf.FR])
            mid = rand_limbs(gen, (A, 16, B), torch, P[cf.FR]) if with_mid else None
            return cf.FR, (x, tw, mid)
        if name in ("ec_add", "ec_double"):
            (shape,) = spec
            n = 6 if name == "ec_add" else 3
            pts = [rand_limbs(gen, shape, torch, P[cf.FQ]) for _ in range(n)]
            # exercise the special cases: identities, P + P, P + (-P)
            if name == "ec_add":
                B = shape[-1]
                pts[2][..., : B // 8] = 0  # P1 = O
                pts[5][..., B // 8 : B // 4] = 0  # P2 = O
                for i in range(3):  # P2 = P1
                    pts[3 + i][..., B // 4 : B // 2] = pts[i][..., B // 4 : B // 2]
                neg = cf.field_sub_plain(cf.FQ, torch.zeros_like(pts[1]), pts[1])
                pts[3][..., B // 2 : 5 * B // 8] = pts[0][..., B // 2 : 5 * B // 8]
                pts[4][..., B // 2 : 5 * B // 8] = neg[..., B // 2 : 5 * B // 8]
                pts[5][..., B // 2 : 5 * B // 8] = pts[2][..., B // 2 : 5 * B // 8]
            return cf.FQ, (tuple(pts[:3]), tuple(pts[3:])) if name == "ec_add" else (tuple(pts),)
        if name == "ec_madd":
            shape, ashape, distinct = spec
            P1 = [rand_limbs(gen, shape, torch, P[cf.FQ]) for _ in range(3)]
            A2 = [rand_limbs(gen, ashape, torch, P[cf.FQ]) for _ in range(2)]
            # the special cases, on lane ranges: accumulator = identity, base =
            # (0, 0), both, base == accumulator (Z = 1; the doubling branch),
            # base == -accumulator
            B = shape[-1]
            cut = [B * i // 10 for i in range(6)]
            one = torch.tensor(
                [((1 << 256) % P[cf.FQ] >> (16 * i)) & 0xFFFF for i in range(16)],
                dtype=torch.int32, device="cuda",
            )[:, None]
            P1[2][..., cut[0] : cut[1]] = 0
            A2[0][..., cut[1] : cut[3]] = 0
            A2[1][..., cut[1] : cut[3]] = 0
            P1[2][..., cut[2] : cut[3]] = 0
            lanes = slice(cut[3], cut[5])
            P1[0][..., lanes] = A2[0][..., lanes]
            P1[1][..., lanes] = A2[1][..., lanes]
            P1[2][..., lanes] = one
            neg = cf.field_sub_plain(cf.FQ, torch.zeros_like(A2[1]), A2[1])
            P1[1][..., cut[4] : cut[5]] = neg[..., cut[4] : cut[5]]
            return cf.FQ, (tuple(P1), tuple(A2), bool(distinct))
        if name == "bucket_scan":
            shape, distinct = spec
            Wb, R, _, CL = shape
            x = rand_limbs(gen, (Wb, R, 16, CL), torch, P[cf.FQ])
            y = rand_limbs(gen, (Wb, R, 16, CL), torch, P[cf.FQ])
            axy = torch.cat(
                [cf_pack(x, torch), cf_pack(y, torch)], dim=2
            )  # [Wb, R, 16, CL]
            dead = torch.rand((Wb, R, 1, CL), generator=gen, device="cuda") < 0.05
            axy = torch.where(dead, torch.zeros_like(axy), axy)
            start = (torch.rand((Wb, R, CL), generator=gen, device="cuda") < 1 / 16).to(torch.int32)
            return cf.FQ, (axy, start, bool(distinct))
        if name == "bucket_sums_fused":
            return cf.FQ, bucket_case(gen, torch, cf, spec, P[cf.FQ], special=True)[0]
        if name == "bucket_weight":
            shape, lanes = spec
            S = [rand_limbs(gen, shape, torch, P[cf.FQ]) for _ in range(3)]
            return cf.FQ, (special_lanes(S, cf, torch), lanes)
        if name == "msm_combine":
            shape, W, c = spec
            T = special_lanes([rand_limbs(gen, shape, torch, P[cf.FQ]) for _ in range(3)],
                              cf, torch)
            combine_specials(T, W, c, cf, torch)
            return cf.FQ, (T, W, c)
        raise KeyError(name)

    def cf_pack(x, torch):
        v = x[..., :8, :].to(torch.int64) | (x[..., 8:, :].to(torch.int64) << 16)
        return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)

    def run(name, fid, args, plain: bool):
        if name in ("mont_mul", "field_add", "field_sub"):
            fn = getattr(cf, f"{name}_plain" if plain else name)
            return (fn(fid, *args),)
        if name == "fermat_inv":
            return ((cf.fermat_inv_plain if plain else cf.fermat_inv)(fid, *args),)
        if name == "ntt_butterfly":
            return (cf.ntt_butterfly_plain if plain else cf.ntt_butterfly)(fid, *args)
        if name == "colntt":
            return ((cf.colntt_plain if plain else cf.colntt)(fid, *args),)
        if name == "ntt_small":
            return ((cf.ntt_small_plain if plain else cf.ntt_small)(fid, *args),)
        if name == "dft_stage":
            return ((cf.dft_stage_plain if plain else cf.dft_stage)(fid, *args),)
        if name == "dft_ntt":
            return ((cf.dft_ntt_plain if plain else cf.dft_ntt)(fid, *args),)
        if name == "ec_add":
            return (cf.ec_add_plain if plain else cf.ec_add)(*args)
        if name == "ec_double":
            return (cf.ec_double_plain if plain else cf.ec_double)(*args)
        if name == "ec_madd":
            return (cf.ec_madd_plain if plain else cf.ec_madd)(*args)
        if name == "bucket_scan":
            return ((cf.bucket_scan_plain if plain else cf.bucket_scan)(*args),)
        if name in ("bucket_sums_fused", "bucket_weight", "msm_combine", "commit_dbl_add",
                    "g1_batch_mul"):
            return getattr(cf, f"{name}_plain" if plain else name)(*args)
        raise KeyError(name)

    def max_err(a, b) -> int:
        return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max()) if x.numel() else 0
                   for x, y in zip(a, b))

    def check(name, spec):
        fid, args = make_inputs(name, spec)
        got = run(name, fid, args, plain=False)
        torch.cuda.synchronize()
        want = run(name, fid, args, plain=True)
        torch.cuda.synchronize()
        err = max_err(got, want)
        if err != 0:
            raise AssertionError(f"kernel {name} disagrees with its plain version: max |diff| {err}")
        return fid, args, err

    # --- 2. kernel checks at ragged sizes -------------------------------------------
    ragged = {
        "mont_mul": ((3, 16, 1000), (16, 1)),
        "field_add": ((3, 16, 1000), (3, 16, 1000)),
        "field_sub": ((3, 16, 1000), (16, 1000)),
        "fermat_inv": ((5, 16, 3),),
        "ntt_butterfly": ((3, 16, 777), (16, 777)),
        "ntt_small": ((3, 16, 64), True, 1),
        "colntt": ((3, 128, 16, 77), True),
        "ec_add": ((2, 16, 1000),),
        "ec_double": ((2, 16, 1000),),
        "ec_madd": ((3, 16, 1000), (16, 1000), False),
        "bucket_scan": ((6, 5, 16, 33), False),
        "bucket_sums_fused": ((7, 512), (512, 16), 16, 63, False),
        "bucket_weight": ((13, 16, 7), 2),
        "msm_combine": ((16, 26), 26, 10),
        "commit_dbl_add": ((3, 16, 13), (16, 20)),
        "dft_stage": ((3, 16, 64, 5), 64, True, 64 * 5),
        "dft_ntt": ((5, 16, 2048), True, 2048),
    }
    for name, spec in ragged.items():
        check(name, spec)
        log(f"[kernels] {name} at {spec}: kernel == plain (max |diff| 0)")
    for spec in (((3, 16, 1000), (16, 1000), True), ((2, 16, 777), (2, 16, 777), False),
                 ((2, 16, 777), (2, 16, 777), True)):
        check("ec_madd", spec)
        log(f"[kernels] ec_madd at {spec}: kernel == plain (max |diff| 0)")
    check("bucket_scan", ((6, 5, 16, 33), True))
    log("[kernels] bucket_scan (distinct) at (6, 5, 16, 33): kernel == plain (max |diff| 0)")
    for spec in (((2, 2, 16, 1000), True), ((1, 8, 16, 333), False), ((5, 32, 16, 1), False),
                 ((2, 4, 16, 50), True), ((2, 16, 16, 40), True), ((2, 64, 16, 70), False),
                 ((1, 256, 16, 40), True), ((1, 1024, 16, 5), True)):
        check("colntt", spec)
        log(f"[kernels] colntt at {spec}: kernel == plain (max |diff| 0)")
    # tw[0] the Montgomery one, as the NTT's tables have it: the kernel skips
    # the products by it
    mont_one = torch.tensor([((1 << 256) % P[cf.FR] >> (16 * i)) & 0xFFFF for i in range(16)],
                            dtype=torch.int32, device="cuda")
    for spec in (((3, 128, 16, 77), True), ((2, 8, 16, 300), False)):
        _, (x, tw, mid) = make_inputs("colntt", spec)
        tw[:, 0] = mont_one
        err = max_err(run("colntt", cf.FR, (x, tw, mid), False), run("colntt", cf.FR, (x, tw, mid), True))
        if err:
            raise AssertionError(f"colntt (tw[0] = 1) at {spec} disagrees with its plain version")
        log(f"[kernels] colntt (tw[0] = 1) at {spec}: kernel == plain (max |diff| 0)")
    # ntt_small at every n and C = 1, 3, 12, 65: the NTT's tables with the
    # diagonal each caller passes (none, 1/n, the coset's pre row, the
    # inverse coset's post row), then random twiddles (tw[0] not one: no
    # product skipped) with both; 0, 1, p - 1 and R mod p among the values;
    # held to the plain version and to the per-stage composition
    for log_n in range(1, 12):
        n = 1 << log_n
        ntt_chk = NTT(fr_df, log_n, dev)
        pre_row = rand_limbs(gen, (16, n), torch, P[cf.FR])
        post_row = ntt_chk.inverse_post(7)
        rand_tw = rand_limbs(gen, (16, n // 2), torch, P[cf.FR])
        variants = {
            "forward": (ntt_chk.tw[True], None, None),
            "inverse (1/n)": (ntt_chk.tw[False], None, ntt_chk.n_inv_mont),
            "forward, pre row": (ntt_chk.tw[True], pre_row, None),
            "inverse, post row": (ntt_chk.tw[False], None, post_row),
            "random tw, pre and post rows": (rand_tw, pre_row, post_row),
        }
        specials = [0, 1, P[cf.FR] - 1, (1 << 256) % P[cf.FR]][:n]
        for C in (1, 3, 12, 65):
            x = rand_limbs(gen, (C, 16, n), torch, P[cf.FR])
            x[0, :, : len(specials)] = torch.tensor(
                [[(v >> (16 * i)) & 0xFFFF for v in specials] for i in range(16)],
                dtype=torch.int32, device="cuda")
            for label, (tw, pre, post) in variants.items():
                got = cf.ntt_small(cf.FR, x, tw, pre, post)
                want = cf.ntt_small_plain(cf.FR, x, tw, pre, post)
                old = ntt_stages(cf.FR, x, tw, pre, post)
                if not (torch.equal(got, want) and torch.equal(got, old)):
                    raise AssertionError(f"ntt_small at n = {n}, C = {C} ({label}) disagrees with "
                                         f"its plain version or the per-stage composition")
        log(f"[kernels] ntt_small at n = {n}, C = 1, 3, 12, 65, {len(variants)} variants: kernel "
            f"== plain == the per-stage composition (max |diff| 0)")
    # the fused bucket accumulation: the special windows at 8, 16 and 256
    # lanes, both distinct values, ragged window counts; then against the
    # composition it replaced (bucket_scan, lane-carry scan, pick, fix)
    for spec in (((7, 512), (512, 16), 8, 63, True), ((9, 4096), (4096, 16), 256, 1023, False),
                 ((13, 4096), (4096, 16), 256, 1023, True)):
        check("bucket_sums_fused", spec)
        log(f"[kernels] bucket_sums_fused at {spec}: kernel == plain (max |diff| 0)")
    for spec in (((7, 512), (512, 16), 16, 63, False), ((11, 4096), (4096, 16), 256, 1023, True),
                 ((6, 4096), (4096, 16), 256, 1023, False)):
        args, A = bucket_case(gen, torch, cf, spec, P[cf.FQ], special=True)
        order, d_sorted, lanes, nb, distinct = args[1:]
        got = cf.bucket_sums_fused(*args)
        want = old_group_bucket_sums(cf, torch, A, order, d_sorted, nb, distinct, lanes)
        err = max_err(got, want)
        if err:
            raise AssertionError(f"bucket_sums_fused at {spec} differs from the old composition")
        log(f"[kernels] bucket_sums_fused at {spec}: == the bucket_scan composition (max |diff| 0)")
    # the fused MSM tail: CL2 = 8 and 64 lanes (the card's) at ragged window
    # counts, and 42 columns of 26 windows (the ECDSA path's widest commit)
    for name, spec in (("bucket_weight", ((7, 16, 255), 8)),
                       ("bucket_weight", ((11, 16, 1023), 64)),
                       ("msm_combine", ((16, 42 * 26), 26, 10))):
        check(name, spec)
        log(f"[kernels] {name} at {spec}: kernel == plain (max |diff| 0)")
    # the fused small-column commit: m = 1, 13 (an odd tree), 512 and 1024,
    # C = 1, 3 and 8, against its plain version and the per-bit composition
    dc_chk = DeviceCurve(DeviceField(FQ_BN254), BN254_G1)
    for spec in (((1, 16, 1), (16, 1)), ((3, 16, 13), (16, 13)), ((8, 16, 512), (16, 512)),
                 ((3, 16, 1024), (16, 1024))):
        fid, args, _ = check("commit_dbl_add", spec)
        if max_err(cf.commit_dbl_add(*args), old_commit_double_and_add(cf, dc_chk, *args)):
            raise AssertionError(f"commit_dbl_add at {spec} differs from the per-bit composition")
        log(f"[kernels] commit_dbl_add at {spec}: kernel == plain == the per-bit composition "
            f"(max |diff| 0)")
    # the inversion on both fields, with 0, 1, p - 1, R mod p and 2^-1
    for fid in (cf.FR, cf.FQ):
        p = P[fid]
        special = [0, 1, p - 1, (1 << 256) % p, pow(2, -1, p)]
        for shape in ((1, 16, 1), (11, 16, 1), (3, 16, 1000)):
            a = rand_limbs(gen, shape, torch, p)
            flat = a.permute(1, 0, 2).reshape(16, -1)  # element j = row j // B, lane j % B
            for j, v in enumerate(special if flat.shape[1] > 1 else [p - 1]):
                flat[:, j] = torch.tensor([(v >> (16 * i)) & 0xFFFF for i in range(16)],
                                          dtype=torch.int32, device="cuda")
            a = flat.reshape(16, shape[0], shape[2]).permute(1, 0, 2).contiguous()
            err = max_err((cf.fermat_inv(fid, a),), (cf.fermat_inv_plain(fid, a),))
            if err:
                raise AssertionError(f"fermat_inv (field {fid}) at {shape} disagrees with its "
                                     f"plain version")
            log(f"[kernels] fermat_inv (field {fid}) at {shape}: kernel == plain (max |diff| 0)")

    def time_ms(fn, reps: int) -> float:
        """Mean milliseconds of fn() on the card (CUDA events), after one
        warm-up call."""
        fn()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    def graph_ms(fn, reps: int) -> float:
        """Mean milliseconds of one replay of fn() captured as a CUDA graph:
        the device's time for its launches without the host's launch path."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return time_ms(graph.replay, reps)

    def host_ints(t) -> list[int]:
        """[..., 16, B] limbs -> the elements as ints, lane fastest."""
        return limbs_to_ints(t.movedim(-2, -1).reshape(-1, 16).cpu().numpy())

    def stage_line(d: dict) -> str:
        return json.dumps({k: round(v, 4) for k, v in d.items()})

    def tampered_rejected(params, vk, proof) -> bool:
        bad = bytearray(proof)
        bad[len(bad) // 2] ^= 1
        return not verify_proof(params, vk, bytes(bad))

    # every NTT call below 2^12 points (NTT.forward / NTT.inverse, which the
    # coset transforms call too; FourStepNTT has its own): its length
    ntt_calls = []

    def counted(method):
        def call(self, x, *args, **kwargs):
            ntt_calls.append(self.n)
            return method(self, x, *args, **kwargs)
        return call

    NTT.forward, NTT.inverse = counted(NTT.forward), counted(NTT.inverse)
    # every MxuNTT call (new_ntt's pick for 2^6..2^11 points on the card):
    # (n, columns, form)
    mxu_calls = []

    def counted_mxu(method, form):
        def call(self, x, *args, **kwargs):
            diag = args[0] if args else next(iter(kwargs.values()), None)
            mxu_calls.append((self.n, x.numel() // (16 * self.n),
                              form + ("" if diag is None else " + diagonal")))
            return method(self, x, *args, **kwargs)
        return call

    MxuNTT.forward = counted_mxu(MxuNTT.forward, "forward")
    MxuNTT.inverse = counted_mxu(MxuNTT.inverse, "inverse")

    def reset_counts() -> None:
        torch.cuda.synchronize()
        cf.reset_launches()
        ntt_calls.clear()
        mxu_calls.clear()

    def ntt_rule(name: str, launches: dict, calls: list, mcalls: list = ()) -> None:
        """One ntt_small launch per radix-2 NTT call and one dft_ntt launch
        per MxuNTT call (every n below 2^12 points); no dft_stage (no path
        builds an MxuNTT above 2^11), no butterfly."""
        if (launches["ntt_small"] != len(calls) or launches["dft_ntt"] != len(mcalls)
                or launches["dft_stage"] or launches["ntt_butterfly"]):
            raise AssertionError(f"{name}: ntt_small {launches['ntt_small']} launches for "
                                 f"{len(calls)} NTT calls, dft_ntt {launches['dft_ntt']} for "
                                 f"{len(mcalls)} MxuNTT calls, dft_stage "
                                 f"{launches['dft_stage']}, ntt_butterfly "
                                 f"{launches['ntt_butterfly']} (want one, one, 0 and 0)")

    # the literal ports of the butterfly, the single point ops and the bucket
    # scan: on no path but phase 12's switch runs (ntt_butterfly)
    off_path = ("ntt_butterfly", "ec_add", "ec_double", "ec_madd", "bucket_scan")

    # --- 12. msm: the reference's MSM benchmark circuit ------------------------------------
    def msm_phase():
        """The MSM circuit of configs/bn254/msm_circuit.t.config (k=13, the
        serial MSM) and msm_circuit.config (k=17, batch 100, multi_exp_par)
        through keygen, the pinned PROVER builder and create_proof, held to
        msm_digests.json; then the prover's switches on a k=12 proof.
        Returns the launches of the two MSM runs and of the switch runs, and
        the k=17 run's largest shapes."""
        t12 = time.time()
        mem12 = torch.cuda.memory_allocated()
        with open(os.path.join(HERE, "tests", "data", "torch_goldens", "msm_digests.json")) as f:
            mref = json.load(f)
        seed = mref["rng_seed"]
        launches, largest = {}, {}
        for key, rel in (("t_config", MSM_T_CONFIG), ("full", MSM_CONFIG)):
            # what make_goldens.py --msm froze of this config (stage by stage)
            cfg, want = load_config(rel), mref.get(key, {})
            k = cfg["degree"]
            tag = f"[msm k={k}]"
            t = time.time()
            params_m = ParamsKZG.setup(k, device=dev)
            t_srs = time.time() - t
            srs_sha = hashlib.sha256(params_m.to_halo2_bytes()).hexdigest()
            if srs_sha != want.get("srs_sha256", srs_sha):
                raise AssertionError(f"{tag} setup({k}) differs from the JAX host SRS")
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            st = {}
            t = time.time()
            port_ec.DEFAULT_RNG.seed(seed)
            builder = msm_circuit(cfg)
            st["witness (MOCK builder)"] = time.time() - t
            t = time.time()
            circuit = builder.synthesize()
            st["synthesize"] = time.time() - t
            t = time.time()
            got = {"config_params": builder.config_params.to_json(),
                   "break_points": builder.break_points(), "digests": circuit_digests(circuit)}
            st["digests (host)"] = time.time() - t
            bad = [part for part in got if part in want and got[part] != want[part]]
            if bad:
                raise AssertionError(f"{tag} the MOCK builder's {bad} differ from the JAX builder's")
            ncopies = len(circuit.copies)
            kst = {}
            # keygen's u16 packing recorded, then packed again on the Python path

            def timed_keygen():
                t = time.time()
                pk = keygen(params_m, builder, circuit, device=dev, timings=kst)
                st["keygen"] = time.time() - t
                return pk

            pk_m, kpacks = packed_both_ways(prover_mod, native, np, timed_keygen)
            peak_keygen = torch.cuda.max_memory_allocated() / 2**30
            torch.cuda.reset_peak_memory_stats()
            del circuit
            vk_sha = hashlib.sha256(pk_m.vk.to_bytes()).hexdigest()
            if "vk_sha256" in want and vk_sha != want["vk_sha256"]:
                raise AssertionError(f"{tag} vk differs from the JAX package's")
            t = time.time()
            pb = pinning_of(builder).prover_builder()
            msm_witness(pb, cfg, None, random.Random(seed))
            st["witness (pinned PROVER builder)"] = time.time() - t
            pst = {}
            t = time.time()
            proof_m = create_proof(params_m, pk_m, pb, seed=0, device=dev, timings=pst)
            st["create_proof"] = time.time() - t
            launches[key], largest[key] = dict(cf.LAUNCHES), dict(cf.LARGEST)
            calls = list(ntt_calls)
            peak = torch.cuda.max_memory_allocated() / 2**30
            t = time.time()
            ok = verify_proof(params_m, pk_m.vk, proof_m)
            st["verify_proof"] = time.time() - t
            if not ok:
                raise AssertionError(f"{tag} proof does not verify")
            if not tampered_rejected(params_m, pk_m.vk, proof_m):
                raise AssertionError(f"{tag} tampered proof verifies")
            proof_sha = hashlib.sha256(proof_m).hexdigest()
            if "proof_sha256" in want and proof_sha != want["proof_sha256"]:
                raise AssertionError(f"{tag} proof differs from the JAX proof's digest")
            cp = builder.config_params
            held = [d for d in ("config_params", "break_points", "digests", "srs_sha256",
                                "vk_sha256", "proof_sha256") if d in want]
            log(f"{tag} {rel}: batch {cfg['batch_size']}, window {cfg['window_bits']}, "
                f"{cfg['limb_bits']}-bit limbs x {cfg['num_limbs']}, lookup_bits "
                f"{cfg['lookup_bits']}; columns: advice {cp.num_advice_per_phase}, lookup "
                f"{cp.num_lookup_advice_per_phase}, fixed {cp.num_fixed} (the reference's config "
                f"file: {cfg['num_advice']} + {cfg['num_lookup_advice']}, fixed "
                f"{cfg['num_fixed']}); {ncopies} copies; {len(pb.pool(0).threads)} contexts")
            log(f"{tag} == the JAX package's (msm_digests.json): {held}; the port's srs sha256 "
                f"{srs_sha}, vk sha256 {vk_sha}, proof {len(proof_m)} bytes, sha256 {proof_sha}; "
                f"verifies, tampered proof rejected")
            log(f"{tag} setup({k}) {t_srs:.3f}s; stages (s) " + stage_line(st))
            log(f"{tag} keygen stages (s): " + stage_line(kst))
            log(f"{tag} keygen u16 packing of {sum(p[0] for p in kpacks)} columns x "
                f"{kpacks[0][1]}: host engine {sum(p[2] for p in kpacks):.4f}s, Python path "
                f"{sum(p[3] for p in kpacks):.4f}s, equal limbs")
            log(f"{tag} create_proof stages (s): " + stage_line(pst))
            log(f"{tag} peak device memory: keygen {peak_keygen:.2f} GiB, create_proof "
                f"{peak:.2f} GiB")
            log(f"{tag} launches: " + json.dumps(launches[key]))
            # every domain is 2^13 or more: the four-step NTT; every commit
            # column has 2^13 points or more: Pippenger
            ntt_rule(tag, launches[key], calls)
            never = ("ntt_small", "dft_stage", "dft_ntt", "commit_dbl_add", "g1_batch_mul",
                     *off_path)
            missing_m = [n for n in cf.KERNELS if n not in never and launches[key][n] == 0]
            if missing_m or any(launches[key][n] for n in never):
                raise AssertionError(f"{tag} launches {launches[key]}: not launched {missing_m}, "
                                     f"want 0 of {never}")
            del builder, pb, pk_m, params_m, proof_m
            torch.cuda.empty_cache()

        # the switches on a k=12 proof (the ECDSA circuit at k=12, about 120
        # advice columns): each proof equals the one without them
        params12 = ParamsKZG.read(os.path.join(HERE, "params", "kzg_bn254_12.srs"), device=dev)
        builder12 = ecdsa_circuit(12, 11, rng=random.Random(0x5EC0))
        b12 = builder12.synthesize()
        pk12 = keygen(params12, builder12, b12, device=dev)
        base12 = create_proof(params12, pk12, b12, seed=0, device=dev)
        if not verify_proof(params12, pk12.vk, base12):
            raise AssertionError("[switch] the k=12 proof does not verify")
        switched = {k: 0 for k in cf.KERNELS}
        runs = (
            ("HALO2_NO_FOURSTEP_NTT=1", {"HALO2_NO_FOURSTEP_NTT": "1"}),
            ("HALO2_NO_FOURSTEP_NTT=1 HALO2_NO_MXU_NTT=1",
             {"HALO2_NO_FOURSTEP_NTT": "1", "HALO2_NO_MXU_NTT": "1"}),
            ("HALO2_PROVER_SELFCHECK=1", {"HALO2_PROVER_SELFCHECK": "1"}),
            ("HALO2_PROVER_SELFCHECK=2", {"HALO2_PROVER_SELFCHECK": "2"}),
            ("HALO2_PROVER_DEBUG=1", {"HALO2_PROVER_DEBUG": "1"}),
        )
        for label, env in runs:
            os.environ.update(env)
            _domain.cache_clear()
            pk12._runtime = None
            err_buf = io.StringIO()
            try:
                reset_counts()
                t = time.time()
                with contextlib.redirect_stderr(err_buf):
                    # under the debug switch keygen too prints its stages
                    pk_s = keygen(params12, builder12, b12, device=dev) if "DEBUG" in label else pk12
                    proof_s = create_proof(params12, pk_s, b12, seed=0, device=dev)
                torch.cuda.synchronize()
                t_s = time.time() - t
                got_l = dict(cf.LAUNCHES)
            finally:
                for var in env:
                    os.environ.pop(var)
                _domain.cache_clear()
                pk12._runtime = None
            err = err_buf.getvalue()
            for n in cf.KERNELS:
                switched[n] += got_l[n]
            want_l = {  # kernel -> launched (True) or not (False) under the switch
                "HALO2_NO_FOURSTEP_NTT=1": {"colntt": False, "dft_stage": True},
                "HALO2_NO_FOURSTEP_NTT=1 HALO2_NO_MXU_NTT=1": {
                    "colntt": False, "dft_stage": False, "ntt_butterfly": True},
            }.get(label, {"colntt": True, "bucket_sums_fused": True})
            wrong = {n: got_l[n] for n, on in want_l.items() if bool(got_l[n]) != on}
            want_err = {
                "HALO2_PROVER_SELFCHECK=1": ["[prover selfcheck] all argument families hold on H\n"],
                "HALO2_PROVER_SELFCHECK=2": [" columns checked\n"],
                "HALO2_PROVER_DEBUG=1": ["[keygen] permutation cycles: ", "[prover] shplonk: "],
            }.get(label, [])
            if (proof_s != base12 or pk_s.vk.to_bytes() != pk12.vk.to_bytes() or wrong
                    or any(w not in err for w in want_err)):
                raise AssertionError(f"[switch] {label}: bytes equal {proof_s == base12}, "
                                     f"launches off {wrong}, stderr {err[-300:]!r}")
            log(f"[switch] k=12 proof with {label} == the proof without it; {t_s:.3f}s; "
                + ", ".join(f"{n} {got_l[n]}" for n in want_l)
                + (f"; stderr: {err.strip().splitlines()[-1]}" if err else ""))
        # HALO2_COMMIT_SIMPLE_MAX is read when backend/kzg.py is imported:
        # the bound it sets there, 0, sends the golden k=9 proof's commits
        # (2^9 points, double-and-add by default) to Pippenger; the JAX bytes
        gold12 = np.load(os.path.join(HERE, "tests", "data", "torch_goldens", "golden_k9.npz"))
        params9s = ParamsKZG.read(os.path.join(HERE, "params", "kzg_bn254_9.srs"), device=dev)
        pk9s = keygen(params9s, golden_circuit(), device=dev)
        old_max, kzg_mod.COMMIT_SIMPLE_MAX = kzg_mod.COMMIT_SIMPLE_MAX, 0
        try:
            reset_counts()
            proof9s = create_proof(params9s, pk9s, golden_circuit(), seed=0, device=dev)
            got_l = dict(cf.LAUNCHES)
        finally:
            kzg_mod.COMMIT_SIMPLE_MAX = old_max
        for n in cf.KERNELS:
            switched[n] += got_l[n]
        if (proof9s != bytes(gold12["proof"]) or got_l["commit_dbl_add"]
                or not got_l["bucket_sums_fused"]):
            raise AssertionError(f"[switch] k=9 with COMMIT_SIMPLE_MAX 0: bytes equal "
                                 f"{proof9s == bytes(gold12['proof'])}, launches {got_l}")
        log(f"[switch] golden k=9 proof with COMMIT_SIMPLE_MAX 0 (HALO2_COMMIT_SIMPLE_MAX=0's "
            f"bound) == golden_k9.npz; commit_dbl_add 0, bucket_sums_fused "
            f"{got_l['bucket_sums_fused']}")
        del params12, builder12, b12, pk12
        # the keys, runtimes and proofs went with their last references (no
        # gc.collect() here): what stays is the domains' cached tables
        held = (torch.cuda.memory_allocated() - mem12) / 2**30
        log(f"[msm] phase 12 {time.time() - t12:.2f}s; device memory allocated "
            f"{mem12 / 2**30:.2f} GiB before it, {held:+.2f} GiB at its end")
        if held > 2:
            raise AssertionError(f"[msm] phase 12 left {held:.2f} GiB allocated on the card")
        return launches["t_config"], launches["full"], switched, largest["full"]

    if "--msm-only" in sys.argv:
        msm_phase()
        log(f"[total] chip_smoke.py --msm-only {time.time() - t_start:.1f}s")
        log(nvidia_smi())
        return

    # --- 13. api: the standalone device API at the north star's sizes -----------------------
    def msm_stages(dc, Pb, digits, c: int):
        """msm_device's steps one by one between CUDA-event marks (sort,
        bucket_sums_fused, bucket_weight, msm_combine; the affine lift's
        select and the bases' packing as "lift"); returns the Jacobian
        point and the stage milliseconds."""
        st = Stages(torch)
        W, n = digits.shape
        inf = dc.df.is_zero(Pb[2])[None, :]
        A = (torch.where(inf, 0, Pb[0]), torch.where(inf, 0, Pb[1]))
        bases = cf.pack_bases(*A)
        st.mark("lift")
        d_sorted, order = torch.sort(digits.to(torch.int32), dim=1, stable=True)
        order = order.to(torch.int32)
        st.mark("sort")
        nb = (1 << c) - 1
        CL = _scan_lanes(n, dev)
        group = max(1, ec_mod._MSM_GROUP_BYTES // (8 * n + 3 * 64 * (nb + CL)))
        parts = [cf.bucket_sums_fused(bases, order[i : i + group], d_sorted[i : i + group], CL,
                                      nb, False) for i in range(0, W, group)]
        S = tuple(torch.cat([q[j] for q in parts], dim=0) for j in range(3))
        st.mark("bucket_sums_fused")
        T = cf.bucket_weight(S, weight_lanes(nb, n, dev))
        st.mark("bucket_weight")
        out = cf.msm_combine(T, W, c)
        st.mark("msm_combine")
        return tuple(t[:, :1] for t in out), st.ms(), len(parts)

    def api_phase():
        """Phase 13: the JAX package's standalone API on the card at the north
        star's sizes: an MSM over 2^20 distinct bases (msm_device and
        DeviceCurve.msm, distinct=False), the NTT at 2^20 and 2^22, and the
        Domain / ParamsKZG / DeviceField API at k = 15. Returns its
        launches and largest launches."""
        t13 = time.time()
        q, r = FQ_BN254.p, FR_BN254.p
        dc13 = DeviceCurve(DeviceField(FQ_BN254), BN254_G1)
        gen13 = torch.Generator(device="cuda")
        gen13.manual_seed(13)
        reset_counts()

        # -- the MSM over 2^20 distinct bases, built on the card (bench.py:222-236)
        log_m = 20
        n = 1 << log_m
        rng13 = random.Random(13)
        s1 = [BN254_G1.random_point(rng13) for _ in range(256)]
        s2 = [BN254_G1.random_point(rng13) for _ in range(256)]
        s3 = [BN254_G1.random_point(rng13) for _ in range(n >> 16)]
        t = time.time()
        idx = torch.arange(n, device=dev)
        g1, g2, g3 = (tuple(t_[:, ix] for t_ in dc13.pack_points(s, dev))
                      for s, ix in ((s1, idx % 256), (s2, (idx >> 8) % 256), (s3, idx >> 16)))
        X, Y, Z = dc13.add(dc13.add(g1, g2), g3)  # ec_add at [16, 2^20], twice
        zinv = dc13.df.batch_inv(Z)  # fermat_inv and the mont_mul prefix products
        zi2 = dc13.df.mont_mul(zinv, zinv)
        Pb = (dc13.df.mont_mul(X, zi2), dc13.df.mont_mul(Y, dc13.df.mont_mul(zi2, zinv)),
              dc13.df.one_mont((n,), dev).contiguous())
        del g1, g2, g3, X, Y, Z, zinv, zi2
        torch.cuda.synchronize()
        t_bases = time.time() - t
        c = msm_window_bits(n, dev)
        W = -(-254 // c)
        digit_sets = [torch.randint(0, 1 << c, (W, n), generator=gen13, device=dev,
                                    dtype=torch.int32) for _ in range(4)]

        def reference(d):
            """sum_i a_i P_i with a_i = sum_w d[w, i] 2^(c w): the digits
            summed per group of i on the card (exact int64), then 528 host
            scalar multiplications of the three point sets."""
            d64 = d.to(torch.int64)
            sums = [d64.reshape(W, n // 256, 256).sum(1),
                    d64.reshape(W, n >> 16, 256, 256).sum((1, 3)),
                    d64.reshape(W, n >> 16, 1 << 16).sum(2)]
            scal = []
            for g in sums:
                g = g.cpu().tolist()
                scal += [sum(g[w][j] << (c * w) for w in range(W)) % r for j in range(len(g[0]))]
            return host_msm(s1 + s2 + s3, scal, q)

        t = time.time()
        want0 = reference(digit_sets[0])
        t_ref = time.time() - t
        got0 = dc13.unpack_points(msm_device(dc13, Pb, digit_sets[0], c))[0]
        if got0 != want0:
            raise AssertionError("[api] msm_device over 2^20 distinct bases differs from the "
                                 "host's three-level reference")
        # DeviceCurve.msm from host points and ints: the same bases and scalars
        t = time.time()
        hx, hy = (dc13.df.unpack(t_) for t_ in Pb[:2])
        host_pts = list(zip(hx, hy))
        bits = ((digit_sets[0].T.cpu()[:, :, None] >> torch.arange(c)) & 1).to(torch.uint8)
        raw = np.packbits(bits.reshape(n, W * c).numpy(), axis=1, bitorder="little")
        scalars = [int.from_bytes(row.tobytes(), "little") for row in raw]
        del bits, raw
        t_host = time.time() - t
        t = time.time()
        got_api = dc13.unpack_points(dc13.msm(host_pts, scalars, c, device=dev))[0]
        t_api = time.time() - t
        if got_api != want0:
            raise AssertionError("[api] DeviceCurve.msm over 2^20 host points differs from the "
                                 "host's reference")
        del host_pts, scalars, hx, hy
        log(f"[api] MSM 2^{log_m}: {n} distinct bases s1[i % 256] + s2[(i >> 8) % 256] + "
            f"s3[i >> 16] built on the card in {t_bases:.3f}s (ec_add x2 at [16, 2^20], "
            f"batch_inv); window {c}, {W} windows of random digits, distinct=False; msm_device "
            f"== DeviceCurve.msm == the host's reference (528 scalar multiplications, "
            f"{t_ref:.3f}s); DeviceCurve.msm from host points and ints {t_api:.3f}s (host "
            f"conversion {t_host:.3f}s)")
        runs = []
        for d in digit_sets[1:]:
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = msm_device(dc13, Pb, d, c)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t)
            if dc13.unpack_points(out)[0] != reference(d):
                raise AssertionError("[api] a timed MSM differs from the host's reference")
        split, stages, groups = msm_stages(dc13, Pb, digit_sets[1], c)
        if any(not torch.equal(a, b) for a, b in
               zip(split, msm_device(dc13, Pb, digit_sets[1], c))):
            raise AssertionError("[api] the MSM run step by step differs from msm_device")
        med = sorted(runs)[1]
        log(f"[api] MSM 2^{log_m} (msm_device, 3 warm runs, host clock): "
            + ", ".join(f"{v:.6f}" for v in runs) + f" s; median {n / med:.1f} points/s; "
            f"stages (ms, CUDA events, {groups} bucket_sums_fused group(s)) " + stage_line(stages))
        result = {"msm": {"n": n, "window_bits": c, "windows": W, "run_s": runs,
                          "points_per_s": n / med, "stages_ms": stages,
                          "bucket_sums_groups": groups}}
        del Pb, digit_sets

        # -- the NTT at 2^20 (four-step against the radix-2 stage loop) and 2^22
        ntt_res = {}
        for log_n in (20, 22):
            nn = 1 << log_n
            four = new_ntt(fr_df, log_n, dev)
            if not isinstance(four, FourStepNTT):
                raise AssertionError(f"[api] new_ntt at 2^{log_n} is {type(four).__name__}")
            x = rand_limbs(gen13, (1, 16, nn), torch, r)
            y = four.forward(x)
            if log_n == 20:
                radix2 = NTT(fr_df, log_n, dev)
                y2 = radix2.forward(x)
                if not torch.equal(y, y2):
                    raise AssertionError("[api] FourStepNTT at 2^20 differs from the radix-2 "
                                         "stage loop")
                del y2
                check = "bit-equal to NTT.forward (the radix-2 stage loop, ntt_butterfly)"
            else:
                if not torch.equal(four.inverse(y), x):
                    raise AssertionError("[api] the 2^22 NTT does not round-trip")
                # the raw limbs are the values times R on both sides, so the
                # host evaluates the raw ints at w^j
                xs = host_ints(x)
                w = FR_BN254.nth_root_of_unity(log_n)
                for j in (1, nn - 3):
                    wj, acc = pow(w, j, r), 0
                    for v in reversed(xs):
                        acc = (acc * wj + v) % r
                    if acc != host_ints(y[..., j : j + 1])[0]:
                        raise AssertionError(f"[api] the 2^22 NTT's output {j} differs from "
                                             f"the host's Horner value")
                del xs
                check = "inverse(forward(x)) == x; outputs 1 and n - 3 == host Horner"
            times = {}
            for label, fn in (("FourStepNTT", four.forward),) + (
                    (("NTT (stage loop)", radix2.forward),) if log_n == 20 else ()):
                fn(x)
                ts = []
                for _ in range(5):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    fn(x)
                    torch.cuda.synchronize()
                    ts.append(time.perf_counter() - t)
                times[label] = ts
            ntt_res[log_n] = {"plan": four.factors, "run_s": times,
                              "elems_per_s": {k: nn / sorted(v)[2] for k, v in times.items()}}
            log(f"[api] NTT 2^{log_n} (plan {four.factors}): {check}; 5 warm runs (s, host "
                f"clock) " + json.dumps({k: [round(v, 6) for v in ts] for k, ts in times.items()})
                + "; median elems/s " + json.dumps({k: round(v, 1) for k, v in
                                                   ntt_res[log_n]["elems_per_s"].items()}))
            del four, x, y
            if log_n == 20:
                del radix2
        result["ntt"] = ntt_res
        torch.cuda.empty_cache()

        # -- the API at the ECDSA domain, k = 15: the card against the CPU and the host
        t = time.time()
        k = 15
        dom = Domain(k)
        hrng = np.random.default_rng(15)
        cvals = [int(v) % r for v in hrng.integers(0, 1 << 62, size=dom.n, dtype=np.int64)]
        cvals = [(v << 190) % r for v in cvals]
        xpt = int(hrng.integers(2, 1 << 62))
        outs = {}
        for d in (dev, torch.device("cpu")):
            C = dom.pack(cvals, d)
            ext = dom.coeff_to_extended(C)
            outs[d.type] = {
                "lagrange_to_coeff": dom.lagrange_to_coeff(C),
                "coeff_to_lagrange": dom.coeff_to_lagrange(C),
                "coeff_to_extended": ext, "extended_to_coeff": dom.extended_to_coeff(ext),
                "divide_by_vanishing": dom.divide_by_vanishing(ext),
                "mul": dom.mul(C, C), "add": dom.add(C, C), "sub": dom.sub(C, dom.const_h(3, d)),
                "rotate_ext": dom.rotate_ext(ext, 1), "const_ext": dom.const_ext(5, d),
                "prefix_prod": dom.prefix_prod(C), "pows_dev": dom.pows_dev(xpt, 1000, d),
                "eval_many_at": dom.eval_many_at(C[None], xpt),
                "pow": dom.df.pow(C[:, :64], r - 2),
            }
        bad = [name for name, v in outs["cuda"].items()
               if (v != outs["cpu"][name] if isinstance(v, list)
                   else not torch.equal(v.cpu(), outs["cpu"][name]))]
        if bad:
            raise AssertionError(f"[api] Domain at k=15: {bad} differ on the card from the CPU")
        torch.cuda.synchronize()
        t_p = time.time()
        dom.df.pow(dom.pack(cvals[:64], dev), r - 2)
        torch.cuda.synchronize()
        t_pow = time.time() - t_p
        if outs["cuda"]["eval_many_at"] != [dom.eval_coeffs_host(cvals, xpt)]:
            raise AssertionError("[api] eval_many_at differs from the host's Horner value")
        # Z_H * q divided by Z_H on the extended coset is q
        qv = cvals[::-1]  # Z_H q = X^n q - q: -q, then q from X^n
        zhq = [(-v) % r for v in qv] + qv + [0] * (dom.n_ext - 2 * len(qv))
        zq = dom.pack(zhq, dev)
        back = dom.extended_to_coeff(dom.divide_by_vanishing(dom.coeff_to_extended(zq)))
        if dom.unpack(back) != qv + [0] * (dom.n_ext - len(qv)):
            raise AssertionError("[api] divide_by_vanishing(Z_H q) is not q")
        del outs, zq, back
        t_dom = time.time() - t
        # commit / commit_lagrange against p(tau) G and sum v_i L_i(tau) G
        t = time.time()
        seed = 1315
        params = ParamsKZG.setup(k, seed=seed, device=dev)
        tau = random.Random(("kzg-srs", seed, k).__repr__()).randrange(1, r)
        coeffs = cvals[: dom.n - 5]
        t_c = time.time()
        cm = params.commit(coeffs)
        t_commit = time.time() - t_c
        ptau = dom.eval_coeffs_host(coeffs, tau)
        lag = _lagrange_scalars(tau, k)
        evals = cvals[::-1]
        t_c = time.time()
        cl = params.commit_lagrange(evals)
        t_commit_l = time.time() - t_c
        ltau = sum(v * w for v, w in zip(evals, lag)) % r
        if cm != BN254_G1.mul(BN254_G1.g, ptau) or cl != BN254_G1.mul(BN254_G1.g, ltau):
            raise AssertionError("[api] commit / commit_lagrange at k=15 differ from p(tau) G / "
                                 "sum v_i L_i(tau) G")
        cols = torch.stack([dom.pack(coeffs + [0] * 5, dev), dom.pack(evals, dev)])
        via_cols = (host_points(params.commit_columns(fr_df, cols[:1], params.affine_bases(dev)))
                    + host_points(params.commit_columns(fr_df, cols[1:],
                                                        params.affine_lagrange_bases(dev))))
        dev_c = params.commit_dev(cols[0], fr_df)
        many = params.commit_many([coeffs, evals], window_bits=8)
        if via_cols != [cm, cl] or dev_c != cm or many[0] != cm:
            raise AssertionError("[api] commit_columns / commit_dev / commit_many at k=15 differ "
                                 "from commit and commit_lagrange")
        del params, cols
        # the 64-point case of tests/test_ec_device.py:58-75 on the card
        crng = random.Random(64)
        pts = [BN254_G1.random_point(crng) for _ in range(64)]
        sc = [BN254_G1.random_scalar(crng) for _ in range(64)]
        pts[3] = None
        sc[5] = 0
        pts[10] = pts[11] = pts[12]
        sc[10] = sc[11] = sc[12]
        pts[20] = pts[21]
        sc[30], sc[31] = 1, 255
        if dc13.unpack_points(dc13.msm(pts, sc, 8, device=dev))[0] != host_msm(pts, sc, q):
            raise AssertionError("[api] DeviceCurve.msm on the duplicate/identity case differs "
                                 "from the host")
        t_kzg = time.time() - t
        log(f"[api] k=15 Domain: 14 methods on the card == on the CPU, eval_many_at == Horner, "
            f"divide_by_vanishing(Z_H q) == q ({t_dom:.3f}s); DeviceField.pow(x, r - 2) at 64 lanes "
            f"{t_pow:.4f}s; setup(15, seed) commit == p(tau) G "
            f"({t_commit:.3f}s), commit_lagrange == sum v_i L_i(tau) G ({t_commit_l:.3f}s), both "
            f"== commit_columns, commit_dev, commit_many; DeviceCurve.msm on the 64-point "
            f"duplicate/identity case == host ({t_kzg:.3f}s)")
        torch.cuda.synchronize()
        launches, largest = dict(cf.LAUNCHES), dict(cf.LARGEST)
        missing = [name for name in API_KERNELS if not launches[name]]
        if missing:
            raise AssertionError(f"[api] not launched in phase 13: {missing}; {launches}")
        log("[api] launches: " + json.dumps(launches))
        log("[api] largest launches: " + json.dumps({k_: [v[0], str(v[1])] for k_, v in
                                                      largest.items()}))
        log(json.dumps({"api": result}))
        log(f"[api] phase 13 {time.time() - t13:.2f}s")
        return launches, largest

    if "--api-only" in sys.argv:
        api_phase()
        log(f"[total] chip_smoke.py --api-only {time.time() - t_start:.1f}s")
        log(nvidia_smi())
        return

    # --- 3. k=9 parity with the JAX goldens ---------------------------------------------
    t = time.time()
    gold = np.load(os.path.join(HERE, "tests", "data", "torch_goldens", "golden_k9.npz"))
    params9 = ParamsKZG.read(os.path.join(HERE, "params", "kzg_bn254_9.srs"), device=dev)
    # the commit calls that take the double-and-add (C >= 1, m <= 1024)
    commit_calls9 = []
    commit_columns9 = params9.commit_columns

    def counted_commit(fr_df, vals, bases, window_bits=None):
        if vals.shape[0] and vals.shape[2] <= COMMIT_SIMPLE_MAX:
            commit_calls9.append(tuple(vals.shape))
        return commit_columns9(fr_df, vals, bases, window_bits)

    params9.commit_columns = counted_commit
    reset_counts()
    t9 = time.time()
    pk9 = keygen(params9, golden_circuit(), device=dev)
    torch.cuda.synchronize()
    t_keygen9 = time.time() - t9
    t9 = time.time()
    proof9 = create_proof(params9, pk9, golden_circuit(), seed=0, device=dev)
    torch.cuda.synchronize()
    t_prove9 = time.time() - t9
    launches9, largest9, ntt_calls9 = dict(cf.LAUNCHES), dict(cf.LARGEST), list(ntt_calls)
    mxu_calls9 = list(mxu_calls)
    params9.commit_columns = commit_columns9
    if pk9.vk.to_bytes() != bytes(gold["vk"]):
        raise AssertionError("k=9 vk bytes differ from the JAX golden")
    if proof9 != bytes(gold["proof"]):
        raise AssertionError("k=9 proof bytes differ from the JAX golden")
    if not verify_proof(params9, pk9.vk, proof9):
        raise AssertionError("k=9 proof does not verify")
    log(f"[k=9] vk and proof byte-identical to the JAX goldens ({len(proof9)} bytes), "
        f"verifies; keygen {t_keygen9:.3f}s, create_proof {t_prove9:.3f}s; "
        f"{time.time() - t:.2f}s in all")
    log("[k=9] launches: " + json.dumps(launches9))
    # the JAX package's device path at k=9: every commit (m <= 1024) by the
    # fused double-and-add, one launch per commit call; no single point op
    # and no Pippenger bucket accumulation
    want9 = {"commit_dbl_add": len(commit_calls9), "ec_madd": 0, "ec_double": 0, "ec_add": 0,
             "bucket_scan": 0, "bucket_sums_fused": 0}
    if not commit_calls9 or any(launches9[k] != v for k, v in want9.items()):
        raise AssertionError(f"k=9 launches {launches9}; want {want9} "
                             f"({len(commit_calls9)} commit calls)")
    ntt_rule("k=9", launches9, ntt_calls9, mxu_calls9)
    if not mxu_calls9 or ntt_calls9:
        raise AssertionError(f"k=9: {len(mxu_calls9)} NTT calls took MxuNTT, {len(ntt_calls9)} "
                             f"ntt_small (want every one MxuNTT)")
    log(f"[k=9] {len(commit_calls9)} commit calls {commit_calls9}, one commit_dbl_add launch "
        f"each; {len(mxu_calls9)} NTT calls (n, columns, form) {mxu_calls9}, one dft_ntt "
        f"launch each, dft_stage and ntt_small 0; mont_mul {launches9['mont_mul']} launches")

    # one k=9 commit three ways: the largest column set the k=9 run committed
    (C9, _, m9), _ = largest9["commit_dbl_add"][1]
    dc9 = params9.device_curve()
    vals9 = fr_df._to_mont(rand_limbs(gen, (C9, 16, m9), torch, P[cf.FR]))
    bases9 = params9.affine_lagrange_bases(dev)
    wb9 = msm_window_bits(m9, dev)
    commits9 = {
        "old loop": lambda: old_commit_double_and_add(cf, dc9, fr_df._from_mont(vals9), *bases9),
        "commit_dbl_add": lambda: commit_double_and_add(dc9, fr_df, vals9, bases9),
        "Pippenger": lambda: msm_many_device(
            dc9, bases9, torch.nn.functional.pad(window_digits(fr_df, vals9, wb9),
                                                 (0, params9.n - m9)), wb9, True),
    }
    jac9 = {k: fn() for k, fn in commits9.items()}
    if max_err(jac9["old loop"], jac9["commit_dbl_add"]):
        raise AssertionError("k=9 commit: commit_dbl_add's Jacobian points differ from the loop's")
    aff9 = {k: _pack_affine(dc9.df, *v) for k, v in jac9.items()}
    if any(not torch.equal(v, aff9["old loop"]) for v in aff9.values()):
        raise AssertionError("k=9 commit: the loop, commit_dbl_add and Pippenger disagree")
    ms9 = {k: time_ms(fn, 3) for k, fn in commits9.items()}
    log(f"[k=9] one commit of {C9} columns x {m9} points: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in ms9.items())
        + f" (Pippenger window {wb9}); the loop and commit_dbl_add equal as Jacobian points, "
        f"all three in affine form")

    # --- 3b. the multi-phase and dynamic-lookup k=9 circuits --------------------------------
    launches_3b = {k: 0 for k in cf.KERNELS}
    keys3b = {}  # phase 10 proves both again over meshes
    for cname in ("multiphase", "dynlookup"):
        t = time.time()
        gold = np.load(os.path.join(HERE, "tests", "data", "torch_goldens", f"{cname}_k9.npz"))
        reset_counts()
        builder = rlc_circuit() if cname == "multiphase" else ram_circuit()
        pk3 = keygen(params9, builder, device=dev)
        keys3b[cname] = (pk3, builder)
        if cname == "multiphase":
            # phase 1 is witnessed from the challenge create_proof squeezes
            pb, phase_fns = rlc_prover(pk3, builder.break_points())
            proof3 = create_proof(params9, pk3, pb, seed=0, phase_fns=phase_fns, device=dev)
        else:
            proof3 = create_proof(params9, pk3, builder, seed=0, device=dev)
        torch.cuda.synchronize()
        launches3, calls3, mcalls3 = dict(cf.LAUNCHES), list(ntt_calls), list(mxu_calls)
        for k in cf.KERNELS:
            launches_3b[k] += launches3[k]
        if pk3.vk.to_bytes() != bytes(gold["vk"]):
            raise AssertionError(f"{cname} k=9 vk bytes differ from the JAX golden")
        if proof3 != bytes(gold["proof"]):
            raise AssertionError(f"{cname} k=9 proof bytes differ from the JAX golden")
        if not verify_proof(params9, pk3.vk, proof3):
            raise AssertionError(f"{cname} k=9 proof does not verify")
        if not tampered_rejected(params9, pk3.vk, proof3):
            raise AssertionError(f"{cname} k=9 tampered proof verifies")
        ntt_rule(cname, launches3, calls3, mcalls3)
        if not mcalls3 or calls3:
            raise AssertionError(f"{cname}: {len(mcalls3)} NTT calls took MxuNTT, {len(calls3)} "
                                 f"ntt_small (want every one MxuNTT)")
        log(f"[3b] {cname}: vk and proof byte-identical to the JAX goldens ({len(proof3)} bytes), "
            f"verifies, tampered proof rejected; {time.time() - t:.2f}s")
        log(f"[3b] {cname}: {len(mcalls3)} NTT calls below 2^12 points, n = "
            f"{sorted({c[0] for c in mcalls3})}, through MxuNTT (dft_ntt "
            f"{launches3['dft_ntt']}, dft_stage {launches3['dft_stage']}, ntt_small "
            f"{launches3['ntt_small']}); colntt "
            f"{launches3['colntt']} launches (the four-step transform, n >= 2^12)")
        log(f"[3b] {cname} launches: " + json.dumps(launches3))

    # --- 4. k=15 slice circuit -------------------------------------------------------------
    t = time.time()
    params = ParamsKZG.read(os.path.join(HERE, "params", "kzg_bn254_15.srs"), device=dev)
    t_read = time.time() - t
    t = time.time()
    builder = slice_circuit()
    cp = builder.config_params
    t_wit = time.time() - t
    log(f"[k=15] SRS read {t_read:.2f}s; witness {t_wit:.2f}s; columns: advice "
        f"{cp.num_advice_per_phase}, lookup {cp.num_lookup_advice_per_phase}, "
        f"fixed {cp.num_fixed}, lookup_bits {cp.lookup_bits}")
    reset_counts()
    kstages, stages = {}, {}
    t = time.time()
    pk = keygen(params, builder, device=dev, timings=kstages)
    torch.cuda.synchronize()
    t_keygen = time.time() - t
    t = time.time()
    proof = create_proof(params, pk, slice_circuit(), seed=0, device=dev, timings=stages)
    torch.cuda.synchronize()
    t_prove = time.time() - t
    launches15, largest15, ntt_calls15 = dict(cf.LAUNCHES), dict(cf.LARGEST), list(ntt_calls)
    t = time.time()
    ok = verify_proof(params, pk.vk, proof)
    t_verify = time.time() - t
    if not ok:
        raise AssertionError("k=15 proof does not verify")
    if not tampered_rejected(params, pk.vk, proof):
        raise AssertionError("k=15 tampered proof verifies")
    digest = hashlib.sha256(proof).hexdigest()
    ref_path = os.path.join(HERE, "tests", "data", "torch_goldens", "slice_k15.json")
    with open(ref_path) as f:
        ref = json.load(f)
    if digest != ref["proof_sha256"]:
        raise AssertionError(f"k=15 proof sha256 {digest} != JAX {ref['proof_sha256']}")
    log(f"[k=15] keygen {t_keygen:.3f}s, create_proof {t_prove:.3f}s, verify_proof "
        f"{t_verify:.3f}s; proof {len(proof)} bytes, sha256 equals the JAX proof's; "
        f"tampered proof rejected")
    log("[k=15] keygen stages (s): " + stage_line(kstages))
    log("[k=15] create_proof stages (s): " + stage_line(stages))
    log("[k=15] launches: " + json.dumps(launches15))

    # --- 4b. the ECDSA circuit at k=15: the main path at full width ---------------------------
    # The witness draws random points; one generator seeded as the JAX
    # package's (0x5EC0), drawn by the keygen builder first and the prover
    # builder second, as bench.py and make_goldens.py --ecdsa build them.
    rng = random.Random(0x5EC0)
    with open(os.path.join(HERE, "tests", "data", "torch_goldens", "ecdsa_k15.json")) as f:
        eref = json.load(f)
    t = time.time()
    ebuilder = ecdsa_circuit(15, 14, rng=rng)
    ecp = ebuilder.config_params
    t_ewit = time.time() - t
    cols = [list(ecp.num_advice_per_phase), list(ecp.num_lookup_advice_per_phase), ecp.num_fixed]
    want_cols = [eref["num_advice_per_phase"], eref["num_lookup_advice_per_phase"], eref["num_fixed"]]
    if cols != want_cols:
        raise AssertionError(f"ECDSA columns {cols} != JAX {want_cols}")
    log(f"[ecdsa] keygen witness {t_ewit:.2f}s; columns: advice {ecp.num_advice_per_phase}, "
        f"lookup {ecp.num_lookup_advice_per_phase}, fixed {ecp.num_fixed}, lookup_bits "
        f"{ecp.lookup_bits}")
    reset_counts()
    ekstages, estages = {}, {}
    t = time.time()
    epk = keygen(params, ebuilder, device=dev, timings=ekstages)
    torch.cuda.synchronize()
    t_ekeygen = time.time() - t
    t = time.time()
    pb = pinning_of(ebuilder).prover_builder()
    erng_state = rng.getstate()  # phase 7 replays the prover witness from here
    ecdsa_witness(pb, ecdsa_inputs(), rng)
    t_epwit = time.time() - t
    t = time.time()
    eproof = create_proof(params, epk, pb, seed=0, device=dev, timings=estages)
    torch.cuda.synchronize()
    t_eprove = time.time() - t
    launches_e, largest_e, ntt_calls_e = dict(cf.LAUNCHES), dict(cf.LARGEST), list(ntt_calls)
    t = time.time()
    ok = verify_proof(params, epk.vk, eproof)
    t_everify = time.time() - t
    log(f"[ecdsa] keygen {t_ekeygen:.3f}s, prover witness (pinned builder) {t_epwit:.3f}s, "
        f"create_proof {t_eprove:.3f}s, verify_proof {t_everify:.3f}s; proof {len(eproof)} bytes")
    log("[ecdsa] keygen stages (s): " + stage_line(ekstages))
    log("[ecdsa] create_proof stages (s): " + stage_line(estages))
    if not ok:
        raise AssertionError("ECDSA proof does not verify")
    if not tampered_rejected(params, epk.vk, eproof):
        raise AssertionError("ECDSA tampered proof verifies")
    evk = hashlib.sha256(epk.vk.to_bytes()).hexdigest()
    edigest = hashlib.sha256(eproof).hexdigest()
    if (evk, edigest) != (eref["vk_sha256"], eref["proof_sha256"]):
        raise AssertionError(
            f"ECDSA vk sha256 {evk}, proof sha256 {edigest} != JAX "
            f"{eref['vk_sha256']}, {eref['proof_sha256']}"
        )
    log("[ecdsa] proof verifies, tampered proof rejected; vk and proof sha256 equal the "
        "JAX package's")
    log("[ecdsa] launches: " + json.dumps(launches_e))

    # k=9 runs the radix-2 NTT (ntt_small) and commits by the fused
    # double-and-add (commit_dbl_add); k=15 runs the four-step colntt and
    # commits by Pippenger (bucket_sums_fused, then the fused tail:
    # bucket_weight and msm_combine, one launch each per MSM call); the
    # literal ports of the butterfly, the single point ops and the bucket
    # scan run nowhere; every other kernel runs at both sizes
    pippenger = ("bucket_sums_fused", "bucket_weight", "msm_combine")
    missing = [k for k in cf.KERNELS
               if k not in ("colntt", "g1_batch_mul", "ntt_small", "dft_stage", *off_path,
                            *pippenger)
               and launches9[k] == 0]
    for name, counts, calls in (("k=15", launches15, ntt_calls15),
                                ("ecdsa", launches_e, ntt_calls_e)):
        # no domain below 2^12 at k=15: neither ntt_small nor dft_stage
        ntt_rule(name, counts, calls)
        never = (*off_path, "commit_dbl_add", "dft_stage", "dft_ntt")
        # the SRS is read from params/ here: no g1_batch_mul (phase 6 makes one)
        missing += [
            f"{k} ({name})" for k in cf.KERNELS
            if k not in ("ntt_small", "g1_batch_mul", *never) and counts[k] == 0
        ]
        per_call = {counts[k] for k in ("bucket_sums_fused", "bucket_weight", "msm_combine")}
        if any(counts[k] for k in never) or len(per_call) != 1:
            raise AssertionError(
                f"{name}: " + ", ".join(f"{k} {counts[k]}" for k in never) + " launches (want 0); "
                + ", ".join(f"{k} {counts[k]}" for k in ("bucket_sums_fused", "bucket_weight",
                                                          "msm_combine")) + " (want equal)"
            )
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    # --- 6. srs + pairing: SRS creation on the card, the pairing circuit at k=19 ----------------
    # (a) setup against the committed files, the Processed format, and
    # g1_batch_mul against its plain version at a few hundred lanes
    t6 = time.time()
    r_fr = FR_BN254.p
    for k in (9, 12, 15):
        with open(os.path.join(HERE, "params", f"kzg_bn254_{k}.srs"), "rb") as f:
            want = f.read()
        st = {}
        t = time.time()
        made = ParamsKZG.setup(k, device=dev, timings=st)
        if made.to_halo2_bytes() != want:
            raise AssertionError(f"setup({k}) on the card differs from params/kzg_bn254_{k}.srs")
        log(f"[srs] setup({k}) on the card == params/kzg_bn254_{k}.srs byte for byte; "
            f"{time.time() - t:.3f}s, stages (s) " + stage_line(st))
        if k == 12:
            proc = made.to_halo2_bytes(raw=False)
            back = ParamsKZG.from_halo2_bytes(proc, device=dev)
            if back.to_halo2_bytes() != want or back.to_halo2_bytes(raw=False) != proc:
                raise AssertionError("setup(12): the Processed round trip changed the SRS")
            log(f"[srs] setup(12): Processed bytes ({len(proc)}) read back to the same SRS")
    # the comb at 300 lanes: 0, 1, r - 1 and every edge scalar of the comb
    # (comb_edge_scalars: carries into and through the top window, every
    # digit at +64 and at -63, digits 0 in the middle, the top entry doubled)
    # among random ones, against the comb's plain version (Jacobian), the
    # old double-and-add (affine) and the host curve (affine)
    edge = [0, 1, r_fr - 1] + list(comb_edge_scalars().values())
    scal = rand_limbs(gen, (16, 300), torch, r_fr)
    for lane, v in enumerate(edge):
        scal[:, lane] = torch.tensor([(v >> (16 * i)) & 0xFFFF for i in range(16)],
                                     dtype=torch.int32, device=dev)
    dcq = DeviceCurve(DeviceField(BN254_G1.base), BN254_G1)
    Gx, Gy = dcq.pack_points_affine([BN254_G1.g], dev)
    got = cf.g1_batch_mul(scal, Gx, Gy)
    if max_err(got, cf.g1_batch_mul_plain(scal, Gx, Gy)):
        raise AssertionError("g1_batch_mul at 300 lanes disagrees with its plain version")
    aff = _affine_mont(dcq.df, *got)
    old_aff = _affine_mont(dcq.df, *old_g1_batch_mul(scal, Gx, Gy))
    if max_err(aff, old_aff):
        raise AssertionError("g1_batch_mul's affine points differ from the old double-and-add's")
    nchk = len(edge) + 5
    some = list(zip(dcq.df.unpack(aff[0][:, :nchk]), dcq.df.unpack(aff[1][:, :nchk])))
    if some != [BN254_G1.mul(BN254_G1.g, v) or (0, 0)
                for v in limbs_to_ints(scal[:, :nchk].T.cpu().numpy())]:
        raise AssertionError("g1_batch_mul's affine points differ from the host curve's")
    log(f"[srs] g1_batch_mul (the comb) at [16, 300] (0, 1, r - 1 and {len(edge) - 3} edge "
        f"scalars among them) == plain (max |diff| 0); affine == the "
        f"old double-and-add's, and its first {nchk} lanes == s G on the host")

    # (b, d) the main path at k=19: gen_srs makes the SRS on the card (into a
    # git-ignored directory, never params/), then the pairing circuit at
    # configs/bn254/pairing_circuit.config: keygen on the MOCK builder, the
    # witness on the pinned PROVER builder, create_proof at seed 0
    srs_dir = os.path.join(HERE, "halo2_lib_tpu_torch", "_build", "params")
    srs19 = os.path.join(srs_dir, "kzg_bn254_19.srs")
    if os.path.exists(srs19):
        os.remove(srs19)
    os.environ["PARAMS_DIR"] = srs_dir
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    srs_st, pkst, ppst = {}, {}, {}
    t = time.time()
    params19 = gen_srs(19, device=dev, timings=srs_st)
    t_srs = time.time() - t
    t = time.time()
    pbuilder = pairing_circuit()
    t_pwit = time.time() - t
    pcp = pbuilder.config_params
    t = time.time()
    pcirc = pbuilder.synthesize()  # kept for phase 8's device mock
    pkst["synthesize"] = time.time() - t
    ppk = keygen(params19, pbuilder, pcirc, device=dev, timings=pkst)
    torch.cuda.synchronize()
    t_pkeygen = time.time() - t
    t = time.time()
    ppb = pairing_witness(pinning_of(pbuilder).prover_builder(), pairing_inputs())
    t_ppwit = time.time() - t
    t = time.time()
    pproof = create_proof(params19, ppk, ppb, seed=0, device=dev, timings=ppst)
    torch.cuda.synchronize()
    t_pprove = time.time() - t
    launches_p, largest_p, ntt_calls_p = dict(cf.LAUNCHES), dict(cf.LARGEST), list(ntt_calls)
    t = time.time()
    ok = verify_proof(params19, ppk.vk, pproof)
    t_pverify = time.time() - t
    log(f"[pairing] columns: advice {pcp.num_advice_per_phase}, lookup "
        f"{pcp.num_lookup_advice_per_phase}, fixed {pcp.num_fixed}, k {pcp.k}, lookup_bits "
        f"{pcp.lookup_bits}, 90-bit limbs x 3")
    log(f"[pairing] gen_srs(19) (setup on the card and write) {t_srs:.3f}s, stages (s) "
        + stage_line(srs_st))
    log(f"[pairing] keygen witness (MOCK builder) {t_pwit:.3f}s, keygen {t_pkeygen:.3f}s, prover "
        f"witness (pinned builder) {t_ppwit:.3f}s, create_proof {t_pprove:.3f}s, verify_proof "
        f"{t_pverify:.3f}s; proof {len(pproof)} bytes")
    log(f"[pairing] peak device memory through create_proof: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("[pairing] keygen stages (s): " + stage_line(pkst))
    log("[pairing] create_proof stages (s): " + stage_line(ppst))
    if not ok:
        raise AssertionError("pairing proof does not verify")
    if not tampered_rejected(params19, ppk.vk, pproof):
        raise AssertionError("pairing tampered proof verifies")
    pvk = hashlib.sha256(ppk.vk.to_bytes()).hexdigest()
    pdigest = hashlib.sha256(pproof).hexdigest()
    with open(srs19, "rb") as f:
        srs19_bytes = f.read()
    psrs = hashlib.sha256(srs19_bytes).hexdigest()
    # pairing_k19.json holds what the JAX run reached: the SRS's digest, then
    # the columns and vk's, then the proof's; each present one must match
    port = {"srs_sha256": psrs, "vk_sha256": pvk, "proof_sha256": pdigest,
            "num_advice_per_phase": list(pcp.num_advice_per_phase),
            "num_lookup_advice_per_phase": list(pcp.num_lookup_advice_per_phase),
            "num_fixed": pcp.num_fixed}
    pref_path = os.path.join(HERE, "tests", "data", "torch_goldens", "pairing_k19.json")
    pref = {}
    if os.path.exists(pref_path):
        with open(pref_path) as f:
            pref = json.load(f)
    held = [key for key in port if key in pref]
    if any(port[key] != pref[key] for key in held):
        raise AssertionError(f"pairing {port} != JAX {pref}")
    log(f"[pairing] equal to the JAX package's (pairing_k19.json): {held or 'nothing frozen'}; "
        f"the port's digests: srs sha256 {psrs}, vk sha256 {pvk}, proof sha256 {pdigest}")
    log("[pairing] proof verifies, tampered proof rejected")
    log("[pairing] launches: " + json.dumps(launches_p))
    # every domain is 2^19 or 2^21: the four-step NTT, no ntt_small; every
    # commit has 2^19 points: Pippenger, no commit_dbl_add; one g1_batch_mul
    ntt_rule("pairing", launches_p, ntt_calls_p)
    never_p = ("ntt_small", "dft_stage", "dft_ntt", "commit_dbl_add", *off_path)
    missing_p = [k for k in cf.KERNELS if k not in never_p and launches_p[k] == 0]
    if (any(launches_p[k] for k in never_p) or launches_p["g1_batch_mul"] != 1
            or launches_p["colntt"] == 0 or missing_p):
        raise AssertionError(f"pairing launches {launches_p}: want 0 of {never_p}, one "
                             f"g1_batch_mul, colntt > 0; not launched: {missing_p}")
    del pbuilder, ppb

    # (b) the k=19 SRS: its first 2^15 monomial points are the committed k=15
    # file's, 64 sampled Lagrange points are L_i(tau) G on the host, and the
    # written file reads back to the same bases
    with open(os.path.join(HERE, "params", "kzg_bn254_15.srs"), "rb") as f:
        srs15_bytes = f.read()
    if srs19_bytes[4 : 4 + 64 * (1 << 15)] != srs15_bytes[4 : 4 + 64 * (1 << 15)]:
        raise AssertionError("setup(19): g[:2^15] differs from params/kzg_bn254_15.srs")
    tau = reference_srs_tau()
    t = time.time()
    lag19 = _lagrange_scalars(tau, 19)
    t_lag = time.time() - t
    idx = sorted(random.Random(19).sample(range(params19.n), 64))
    q_fq, rinv = FQ_BN254.p, pow(1 << 256, -1, FQ_BN254.p)
    got_lag = [tuple(v * rinv % q_fq for v in limbs_to_ints(params19._raw_xy[1][i])) for i in idx]
    if got_lag != [BN254_G1.mul(BN254_G1.g, lag19[i]) for i in idx]:
        raise AssertionError("setup(19): sampled Lagrange points differ from L_i(tau) G")
    back19 = ParamsKZG.read(srs19, device=dev)
    if (not np.array_equal(back19._raw_xy, params19._raw_xy)
            or (back19.g2, back19.s_g2) != (params19.g2, params19.s_g2)
            or any(not torch.equal(a, b) for a, b in zip(back19.affine_lagrange_bases(dev),
                                                         params19.affine_lagrange_bases(dev)))):
        raise AssertionError("setup(19): the written file reads back to other bases")
    log(f"[srs] setup(19): g[:2^15] == params/kzg_bn254_15.srs's points; 64 sampled Lagrange "
        f"points == L_i(tau) G on the host (scalars {t_lag:.2f}s); {len(srs19_bytes)} bytes "
        f"written and read back to the same bases")

    # (c) the MSM at n = 2^19 on both bases against the host: commit(p) =
    # p(tau) G (monomial), sum_i v_i L_i(tau) G (Lagrange)
    n19 = params19.n
    npg = np.random.default_rng(19)
    limbs = npg.integers(0, 1 << 16, size=(3, n19, 16), dtype=np.int64)
    limbs[..., 15] %= r_fr >> 240
    cols19 = [limbs_to_ints(c) for c in limbs]
    vals19 = fr_df._to_mont(torch.from_numpy(limbs.transpose(0, 2, 1).astype(np.int32)).to(dev))
    taus19 = _tau_powers(tau, n19)
    for basis, weights in (("monomial", taus19), ("Lagrange", lag19)):
        bases = params19.affine_bases(dev) if basis == "monomial" else params19.affine_lagrange_bases(dev)
        torch.cuda.synchronize()
        t = time.time()
        got = host_points(params19.commit_columns(fr_df, vals19, bases))
        t_msm = time.time() - t
        want = [BN254_G1.mul(BN254_G1.g, sum(c * w for c, w in zip(col, weights)) % r_fr)
                for col in cols19]
        if got != want:
            raise AssertionError(f"MSM at 2^19 ({basis} basis) differs from the host's p(tau) G")
        log(f"[msm19] 3 columns x 2^19 points, {basis} basis: == the host oracle; "
            f"{t_msm * 1e3:.1f} ms (host clock, with the digits and the affine conversion)")
    del vals19, cols19, limbs

    # (c) the four-step NTT at 2^19 and 2^21 against the JAX NTT's digests
    with open(os.path.join(HERE, "tests", "data", "torch_goldens", "ntt_digests_large.json")) as f:
        nref = json.load(f)
    for log_n in (19, 21):
        x = fr_df._to_mont(torch.from_numpy(ntt_input_limbs(log_n, np)).to(dev))
        ntt_l, coset_l = new_ntt(fr_df, log_n, dev), CosetNTT(fr_df, log_n, 7, dev)
        outs = {"forward": ntt_l.forward(x), "inverse": ntt_l.inverse(x),
                "coset_forward": coset_l.forward(x), "coset_inverse": coset_l.inverse(x)}
        digests = {k: hashlib.sha256(v.cpu().numpy().astype("<u4").tobytes()).hexdigest()
                   for k, v in outs.items()}
        if digests != nref[str(log_n)]:
            raise AssertionError(f"NTT at 2^{log_n} differs from the JAX digests: {digests}")
        log(f"[ntt] 2^{log_n} (factors {ntt_l.factors}): forward, inverse, coset forward and "
            f"coset inverse of 2 columns == the JAX NTT's SHA-256")
        del x, outs
    del params19, back19, ppk
    torch.cuda.empty_cache()
    log(f"[pairing] phase 6 {time.time() - t6:.2f}s")

    # --- 7. the bench path: ECDSA k=15 warm, plain and pipelined ------------------------------
    # bench.py's e2e region (bench.py:122-160) on phase 4b's params, key and
    # pinning: the pinned prover builder, then the witness and create_proof,
    # or the phase-0 pipeline around the witness and create_proof with it.
    # Every run replays the prover witness from the generator state phase 4b's
    # started from, so every proof is the JAX digest's.
    t7 = time.time()
    t = time.time()
    ntasks = warm_prover(params, epk, device=dev)
    log(f"[bench] warm_prover: {ntasks} tasks in {time.time() - t:.3f}s (kernel library loaded, "
        f"the pk's runtime cached since phase 4b)")
    epin = pinning_of(ebuilder)

    def bench_e2e(pipelined: bool):
        """One e2e run: (proof, seconds, stage seconds, the pipeline's commit
        groups or None)."""
        r = random.Random()
        r.setstate(erng_state)
        st, groups = {}, None
        torch.cuda.synchronize()
        t0 = time.time()
        pb = epin.prover_builder()
        if pipelined:
            pipe = Phase0Pipeline(params, epk, pb, device=dev).run(
                lambda b: ecdsa_witness(b, ecdsa_inputs(), r))
            st["witness + pipeline"] = time.time() - t0
            proof = create_proof(params, epk, pb, seed=0, device=dev, timings=st, phase0=pipe)
            groups = pipe.groups
        else:
            ecdsa_witness(pb, ecdsa_inputs(), r)
            st["witness"] = time.time() - t0
            proof = create_proof(params, epk, pb, seed=0, device=dev, timings=st)
        return proof, time.time() - t0, st, groups

    # plain and pipelined in turns
    turns = ["plain", "pipelined", "pipelined", "plain"]
    bench_runs, bench_proofs, launches_b = [], [], None
    for i, label in enumerate(turns):
        if i == 1:
            reset_counts()
        proof_b, secs, st, groups = bench_e2e(label == "pipelined")
        if i == 1:
            torch.cuda.synchronize()
            launches_b = dict(cf.LAUNCHES)
        bench_proofs.append(proof_b)
        bench_runs.append({"run": label, "e2e_s": round(secs, 4),
                           "stages_s": {k: round(v, 4) for k, v in st.items()},
                           "commit_groups": groups})
        log(f"[bench] {label}: e2e {secs:.3f}s (witness + create_proof, warm key); stages (s) "
            + stage_line(st) + (f"; columns per commit call {groups}" if groups else ""))
    if any(pb_ != bench_proofs[0] for pb_ in bench_proofs):
        raise AssertionError("bench path: the plain and pipelined proofs differ")
    bdigest = hashlib.sha256(bench_proofs[0]).hexdigest()
    if bdigest != eref["proof_sha256"]:
        raise AssertionError(f"bench path: proof sha256 {bdigest} != JAX {eref['proof_sha256']}")
    if not verify_proof(params, epk.vk, bench_proofs[1]):
        raise AssertionError("bench path: the pipelined proof does not verify")
    if not tampered_rejected(params, epk.vk, bench_proofs[1]):
        raise AssertionError("bench path: a tampered pipelined proof verifies")
    log(f"[bench] {len(turns)} proofs byte-equal, sha256 == the JAX ECDSA digest; the pipelined "
        f"proof verifies, a tampered copy is rejected")
    log("[bench] the pipelined proof's launches: " + json.dumps(launches_b))
    log(json.dumps({"bench_runs": bench_runs}))
    # the pipelined ECDSA proof runs the ECDSA path's kernels, the commits of
    # its advice columns on the pipeline's stream among them
    never_b = (*off_path, "commit_dbl_add", "ntt_small", "dft_stage", "dft_ntt", "g1_batch_mul")
    missing_b = [k for k in cf.KERNELS if k not in never_b and launches_b[k] == 0]
    if missing_b or any(launches_b[k] for k in never_b):
        raise AssertionError(f"bench path launches {launches_b}: not launched {missing_b}, "
                             f"want 0 of {never_b}")

    # the k=9 golden circuit pipelined: its columns commit by commit_dbl_add
    # on the pipeline's stream
    gold9 = np.load(os.path.join(HERE, "tests", "data", "torch_goldens", "golden_k9.npz"))
    reset_counts()
    pipe9 = Phase0Pipeline(params9, pk9, Pinning(pk9.config_params, pk9.break_points)
                           .prover_builder(), device=dev).run(golden_witness)
    torch.cuda.synchronize()
    dbl_add9 = cf.LAUNCHES["commit_dbl_add"]
    proof9p = create_proof(params9, pk9, pipe9.builder, seed=0, device=dev, phase0=pipe9)
    if proof9p != bytes(gold9["proof"]):
        raise AssertionError("k=9 pipelined proof differs from the JAX golden")
    if dbl_add9 != len(pipe9.groups) or dbl_add9 == 0:
        raise AssertionError(f"k=9 pipeline: {dbl_add9} commit_dbl_add launches for commit "
                             f"groups {pipe9.groups}")
    log(f"[bench] k=9 golden circuit pipelined: proof == golden_k9.npz; columns per commit call "
        f"{pipe9.groups}, one commit_dbl_add launch each on the pipeline's stream")
    log(f"[bench] phase 7 {time.time() - t7:.2f}s")

    # --- 7b. the host engine against the Python path on the bench path -------------------------
    # phase 7's plain e2e region in turns engine, Python path, Python path,
    # engine (native.python_path: every hook of the witness and the packing
    # on the Python path); each create_proof's _u16_cols calls recorded and
    # packed again the other way, the limbs equal, every proof the JAX digest
    t7b = time.time()
    mem_7b = torch.cuda.memory_allocated() / 2**30

    def engine_turn(python: bool):
        def run():
            with native.python_path() if python else contextlib.nullcontext():
                r = random.Random()
                r.setstate(erng_state)
                st = {}
                torch.cuda.synchronize()
                t0 = time.time()
                pb = epin.prover_builder()
                ecdsa_witness(pb, ecdsa_inputs(), r)
                st["witness"] = time.time() - t0
                proof = create_proof(params, epk, pb, seed=0, device=dev, timings=st)
                return proof, time.time() - t0, st
        return packed_both_ways(prover_mod, native, np, run, python)

    engine_runs = []
    for label in ("engine", "python", "python", "engine"):
        (proof_n, secs, st), packs = engine_turn(label == "python")
        digest = hashlib.sha256(proof_n).hexdigest()
        if digest != eref["proof_sha256"]:
            raise AssertionError(f"[engine] {label}: proof sha256 {digest} != JAX")
        # the key's runtime is cached (phase 7), so the first call packs the
        # advice and lookup-advice columns (and the instance columns) of
        # phase 0; each turn's packing is timed again the other way
        ncols, n, t_engine, t_python = packs[0]
        engine_runs.append({
            "run": label, "e2e_s": secs, "witness_s": st["witness"],
            "advice_u16_cols": [ncols, n], "advice_packing_engine_s": t_engine,
            "advice_packing_python_s": t_python,
            "all_u16_cols_engine_s": sum(p[2] for p in packs),
            "all_u16_cols_python_s": sum(p[3] for p in packs), "stages_s": st,
        })
        log(f"[engine] {label}: e2e {secs:.4f}s, witness {st['witness']:.4f}s; advice "
            f"_u16_cols ({ncols} x {n}) engine {t_engine:.4f}s, Python path {t_python:.4f}s, "
            f"equal limbs; stages (s) " + stage_line(st))
    log(f"[engine] 4 proofs (engine, Python path, Python path, engine) == the JAX ECDSA digest; "
        f"phase 7b {time.time() - t7b:.2f}s; device memory {mem_7b:.2f} GiB allocated before "
        f"it, {torch.cuda.memory_allocated() / 2**30:.2f} after")
    log(json.dumps({"engine_runs": engine_runs}))

    # --- 8. the device MockProver -----------------------------------------------------------
    # the ECDSA MOCK circuit (phase 4b), the pairing MOCK circuit (phase 6),
    # each again with one advice value changed; a small circuit with a broken
    # copy and an out-of-range lookup value
    t8 = time.time()
    reset_counts()
    t = time.time()
    ecirc = ebuilder.synthesize()
    t_esyn = time.time() - t
    t = time.time()
    host_e = MockProver(ecirc, None).verify()
    t_host_e = time.time() - t

    def device_mock(circ):
        torch.cuda.synchronize()
        t0 = time.time()
        errs = DeviceMockProver(circ, dev).verify()
        torch.cuda.synchronize()
        return errs, time.time() - t0

    dev_e, t_dev_e = device_mock(ecirc)
    if host_e or dev_e:
        raise AssertionError(f"ECDSA mock: host {host_e[:3]}, device {dev_e[:3]} (want none)")
    log(f"[mock] ECDSA k=15 ({sum(len(c) for c in ecirc.phases[0].columns)} advice cells, "
        f"{len(ecirc.copies)} copies): host MockProver {t_host_e:.3f}s, DeviceMockProver "
        f"{t_dev_e:.3f}s, both satisfied (synthesize {t_esyn:.3f}s)")
    # the host MockProver's gate scan (backend/mock.py gate_failures, Python)
    # against the host engine's gate-column check (NativeField, C; the JAX
    # package's opt-in HALO2_NATIVE_MOCK path) over the same columns, in
    # turns Python, C, C, Python: the first failing row of every column equal
    gate_cols = [(v, s) for fp in ecirc.phases for v, s in zip(fp.columns, fp.selectors)]
    nf = native.NativeField(FR_BN254.p)
    gate_runs = []
    for label in ("python", "engine", "engine", "python"):
        t = time.time()
        if label == "python":
            firsts = [next(gate_failures(v, s, FR_BN254.p), (-1,))[0] for v, s in gate_cols]
        else:
            firsts = [nf.check_gate_column(v, s) for v, s in gate_cols]
        gate_runs.append((label, time.time() - t))
        if set(firsts) != {-1}:
            raise AssertionError(f"[mock] {label} gate scan of the ECDSA circuit: {firsts}")
    log(f"[mock] ECDSA k=15 gate scan of {len(gate_cols)} columns (first failing row of each, "
        f"none): " + ", ".join(f"{lb} {secs:.4f}s" for lb, secs in gate_runs))
    dev_p, t_dev_p = device_mock(pcirc)
    if dev_p:
        raise AssertionError(f"pairing mock: {dev_p[:3]} (want none)")
    log(f"[mock] pairing k=19 ({sum(len(c) for c in pcirc.phases[0].columns)} advice cells, "
        f"{len(pcirc.copies)} copies): DeviceMockProver {t_dev_p:.3f}s, satisfied")

    def pranked(circ, name):
        """One advice value changed at a row whose gate is on: the device
        mock names that column and row."""
        cols, sels = circ.phases[0].columns, circ.phases[0].selectors
        c = len(sels) // 2
        r = next(i for i, q in enumerate(sels[c]) if q and i >= len(sels[c]) // 2)
        old = cols[c][r]
        cols[c][r] = (old + 1) % FR_BN254.p
        try:
            errs, secs = device_mock(circ)
        finally:
            cols[c][r] = old
        want = f"gate failure at phase 0 column {c} row {r}"
        if want not in errs:
            raise AssertionError(f"{name} pranked at column {c} row {r}: {errs}")
        log(f"[mock] {name} with column {c} row {r} changed: {errs} ({secs:.3f}s)")

    pranked(ecirc, "ECDSA")
    pranked(pcirc, "pairing")
    small = golden_circuit().synthesize()
    small.copies.append((("advice", 0, 0, 0), ("advice", 0, 0, 1)))
    small.lookup_cols[0][0][3] = 1 << small.params.lookup_bits
    dev_s, _ = device_mock(small)
    want_s = ["2 copy constraint failures", "1 lookup failures"]
    if dev_s != want_s or DeviceMockProver(small, "cpu").verify() != want_s:
        raise AssertionError(f"small circuit mock: {dev_s}, want {want_s}")
    if not MockProver(small, None).verify():
        raise AssertionError("small circuit: the host MockProver misses the failures")
    del gate_cols
    torch.cuda.synchronize()
    launches_m = dict(cf.LAUNCHES)
    log(f"[mock] golden circuit with a broken copy and a lookup value of 2^8: {dev_s} "
        f"(== the plain version on the CPU; the host MockProver fails it too)")
    log("[mock] launches: " + json.dumps(launches_m))
    if any(launches_m[k] == 0 for k in ("mont_mul", "field_add", "field_sub")):
        raise AssertionError(f"device mock launches {launches_m}: the stencil's kernels missing")
    del ecirc, pcirc, small
    log(f"[mock] phase 8 {time.time() - t8:.2f}s")

    # --- 9. gadgets: Poseidon + SafeTypes through base_test().bench_builder -------------------
    t9g = time.time()
    os.environ["PARAMS_DIR"] = os.path.join(HERE, "params")  # the committed k=9 SRS
    pgold = np.load(os.path.join(HERE, "tests", "data", "torch_goldens", "poseidon_k9.npz"))
    reset_counts()
    tester = base_test().use_k(POSEIDON_K).use_lookup_bits(POSEIDON_LOOKUP_BITS).use_device(dev)
    gst = {}
    gproof = tester.bench_builder(poseidon_inputs(1), poseidon_inputs(2), poseidon_logic,
                                  timings=gst)
    torch.cuda.synchronize()
    launches_g = dict(cf.LAUNCHES)
    gvk = tester.pk.vk
    if gvk.to_bytes() != bytes(pgold["vk"]) or gproof != bytes(pgold["proof"]):
        raise AssertionError("Poseidon k=9: vk or proof bytes differ from the JAX golden")
    bad = bytearray(gproof)
    bad[len(bad) // 2] ^= 1
    check_proof(tester.params, gvk, bytes(bad), expect_satisfied=False)
    log(f"[gadgets] Poseidon + SafeTypes at k=9 ({gvk.num_advice} advice, {gvk.num_lookup} lookup "
        f"columns): bench_builder's vk and proof == the JAX golden, verifies, tampered proof "
        f"rejected; steps (s) " + stage_line(gst))
    log("[gadgets] launches: " + json.dumps(launches_g))
    never_g = (*off_path, "colntt", *pippenger, "g1_batch_mul", "ntt_small", "dft_stage")
    missing_g = [k for k in cf.KERNELS if k not in never_g and launches_g[k] == 0]
    if missing_g or any(launches_g[k] for k in never_g):
        raise AssertionError(f"gadgets launches {launches_g}: not launched {missing_g}, "
                             f"want 0 of {never_g}")
    log(f"[gadgets] phase 9 {time.time() - t9g:.2f}s")

    # --- 10. mesh: the sharded NTT, MSM and create_proof(mesh=) -------------------------------
    launches_mesh, largest_mesh = mesh_phase(
        torch, np, dev, (params9, pk9, keys3b, params, epk, ebuilder, erng_state))

    # --- 11. mxu: the digit-plane DFT NTT (dft_stage) ---------------------------------------
    t11 = time.time()
    # dft_stage against its plain version at R, C in 8..256 (the stage
    # shapes of 2^6..2^16 points), 1, 3, 12 and 105 columns (fewer where the
    # plain version's pair products would pass 2^26 entries) with the
    # diagonals' forms: none, pre row and post block, the 1/n scalar, a post
    # block alone; p - 1 among the values
    pm1 = torch.tensor([((P[cf.FR] - 1) >> (16 * j)) & 0xFFFF for j in range(16)],
                       dtype=torch.int32, device=dev)
    n_dft = 0
    for R in (8, 16, 32, 64, 128, 256):
        for C in (8, 16, 32, 64, 128, 256):
            forms = ((False, 0), (True, R * C), (False, 1), (False, R * C))
            for L, (with_pre, post_n) in zip((1, 3, 12, 105), forms):
                if L > 1 and 1024 * R * L * C > 1 << 26:
                    L = max(1, (1 << 26) // (1024 * R * C))
                fid, args = make_inputs("dft_stage", ((L, 16, R, C), R, with_pre, post_n))
                args[0][0, :, 0, 0] = pm1
                if max_err(run("dft_stage", fid, args, False), run("dft_stage", fid, args, True)):
                    raise AssertionError(f"dft_stage at L, R, C = {L}, {R}, {C} (pre {with_pre}, "
                                         f"post {post_n}) disagrees with its plain version")
                n_dft += 1
    log(f"[mxu] dft_stage == plain at {n_dft} shapes: R, C in 8..256, 1/3/12/105 columns, "
        f"pre and post diagonals (max |diff| 0)")
    # MxuNTT against the radix-2 and four-step transforms, all four forms
    for log_n in (6, 7, 8, 9, 10, 11, 12, 15, 17):
        n = 1 << log_n
        mxu = MxuNTT(fr_df, log_n, dev)
        ref = (NTT if log_n < 12 else FourStepNTT)(fr_df, log_n, dev)
        x = rand_limbs(gen, (3, 16, n), torch, P[cf.FR])
        pre = rand_limbs(gen, (16, n), torch, P[cf.FR])
        pairs = ((mxu.forward(x), ref.forward(x)), (mxu.inverse(x), ref.inverse(x)),
                 (mxu.forward(x, pre=pre), ref.forward(x, pre=pre)),
                 (mxu.inverse(x, post=mxu.inverse_post(7)), ref.inverse(x, post=ref.inverse_post(7))))
        if any(not torch.equal(a, b) for a, b in pairs):
            raise AssertionError(f"MxuNTT 2^{log_n} differs from {type(ref).__name__}")
    log("[mxu] MxuNTT == NTT at 2^6..2^11 and == FourStepNTT at 2^12, 2^15 and 2^17 (forward, "
        "inverse, pre, post; 3 columns)")
    # dft_ntt against its plain version at 2^6..2^11, 1, 3, 12 and 105
    # columns, the four forms; one launch each
    n_ntt = 0
    for log_n in range(6, 12):
        n = 1 << log_n
        mxu = MxuNTT(fr_df, log_n, dev)
        pre = rand_limbs(gen, (16, n), torch, P[cf.FR])
        forms = [(mxu._consts[True], None, None), (mxu._consts[True], pre, None),
                 (mxu._consts[False], None, mxu.n_inv_mont),
                 (mxu._consts[False], None, mxu.inverse_post(7))]
        for C in (1, 3, 12, 105):
            x = rand_limbs(gen, (C, 16, n), torch, P[cf.FR])
            x[0, :, 0] = pm1
            for (tw, w1, w2), pr, po in forms:
                cf.reset_launches()
                got = cf.dft_ntt(cf.FR, x, w1, w2, tw, pr, po)
                if (cf.LAUNCHES["dft_ntt"] != 1
                        or not torch.equal(got, cf.dft_ntt_plain(cf.FR, x, w1, w2, tw, pr, po))):
                    raise AssertionError(f"dft_ntt at [{C}, 16, {n}] disagrees with its plain "
                                         f"version")
                n_ntt += 1
    log(f"[mxu] dft_ntt == plain at {n_ntt} cases: 2^6..2^11, 1/3/12/105 columns, forward, "
        f"pre, 1/n, post (max |diff| 0), one launch each")
    # timing, in turns old, mxu, mxu, old: the k=9 paths' largest calls
    # against ntt_small, the four-step sizes against FourStepNTT
    big9 = {}
    for n, C, form in mxu_calls9:
        if C > big9.get(n, (0, ""))[0]:
            big9[n] = (C, form)
    mxu_runs = []
    for n, (C, form) in sorted(big9.items()):
        log_n = n.bit_length() - 1
        mxu, old = MxuNTT(fr_df, log_n, dev), NTT(fr_df, log_n, dev)
        x = rand_limbs(gen, (C, 16, n), torch, P[cf.FR])
        diag = rand_limbs(gen, (16, n), torch, P[cf.FR]) if "diagonal" in form else None
        fwd = form.startswith("forward")

        def call(t, x=x, diag=diag, fwd=fwd):
            return t.forward(x, pre=diag) if fwd else t.inverse(x, post=diag)

        if not torch.equal(call(mxu), call(old)):
            raise AssertionError(f"MxuNTT {form} at [{C}, 16, {n}] differs from NTT")
        turns = [time_ms(lambda t=t: call(t), 20) for t in (old, mxu, mxu, old)]
        graphs = [graph_ms(lambda t=t: call(t), 20) for t in (old, mxu, mxu, old)]
        mxu_runs.append({"n": n, "columns": C, "form": form, "against": "NTT (ntt_small)",
                         "old_ms": [round(v, 6) for v in turns[::3]],
                         "mxu_ms": [round(v, 6) for v in turns[1:3]],
                         "old_graph_ms": [round(v, 6) for v in graphs[::3]],
                         "mxu_graph_ms": [round(v, 6) for v in graphs[1:3]]})
    for log_n in (15, 17):
        n = 1 << log_n
        mxu, old = MxuNTT(fr_df, log_n, dev), FourStepNTT(fr_df, log_n, dev)
        x = rand_limbs(gen, (2, 16, n), torch, P[cf.FR])
        turns = [time_ms(lambda t=t: t.forward(x), 5) for t in (old, mxu, mxu, old)]
        mxu_runs.append({"n": n, "columns": 2, "form": "forward", "against": "FourStepNTT (colntt)",
                         "old_ms": [round(v, 6) for v in turns[::3]],
                         "mxu_ms": [round(v, 6) for v in turns[1:3]]})
    for r in mxu_runs:
        log(f"[mxu] 2^{r['n'].bit_length() - 1} x {r['columns']} columns, {r['form']}: MxuNTT "
            f"{r['mxu_ms']} ms, {r['against']} {r['old_ms']} ms (CUDA events, turns old, mxu, "
            f"mxu, old)" + (f"; as CUDA graphs (device time) MxuNTT {r['mxu_graph_ms']} ms, "
                            f"{r['against']} {r['old_graph_ms']} ms" if "mxu_graph_ms" in r else ""))
    # the paths that run MxuNTT: the k=9 proofs (phases 3, 3b), the gadgets
    # (9) and the meshes' sub-transforms (10), all through dft_ntt
    mxu_paths = {"k9": launches9, "k9_phases": launches_3b, "gadgets": launches_g,
                 "mesh": launches_mesh}
    for label, counts in mxu_paths.items():
        if (counts["dft_ntt"] == 0 or counts["dft_stage"]
                or (label != "mesh" and counts["ntt_small"])):
            raise AssertionError(f"{label}: dft_ntt {counts['dft_ntt']}, dft_stage "
                                 f"{counts['dft_stage']}, ntt_small {counts['ntt_small']} launches")
    log("[mxu] launches (dft_ntt, dft_stage, ntt_small): " + json.dumps(
        {k: [v["dft_ntt"], v["dft_stage"], v["ntt_small"]] for k, v in mxu_paths.items()}))
    # the golden k=9 proof again with HALO2_NO_MXU_NTT=1: new domains (the
    # domain cache cleared), every NTT radix-2, the same bytes
    gold9 = np.load(os.path.join(HERE, "tests", "data", "torch_goldens", "golden_k9.npz"))
    os.environ["HALO2_NO_MXU_NTT"] = "1"
    _domain.cache_clear()
    try:
        reset_counts()
        t = time.time()
        pk_r = keygen(params9, golden_circuit(), device=dev)
        proof_r = create_proof(params9, pk_r, golden_circuit(), seed=0, device=dev)
        torch.cuda.synchronize()
        t_r = time.time() - t
        launches_r, calls_r = dict(cf.LAUNCHES), list(ntt_calls)
    finally:
        os.environ.pop("HALO2_NO_MXU_NTT")
        _domain.cache_clear()
    if proof_r != bytes(gold9["proof"]) or pk_r.vk.to_bytes() != bytes(gold9["vk"]):
        raise AssertionError("k=9 with HALO2_NO_MXU_NTT=1: vk or proof bytes differ from the golden")
    ntt_rule("k=9, HALO2_NO_MXU_NTT=1", launches_r, calls_r)
    if not calls_r:
        raise AssertionError("k=9 with HALO2_NO_MXU_NTT=1: no NTT call took ntt_small")
    log(f"[mxu] k=9 golden with HALO2_NO_MXU_NTT=1: vk and proof == golden_k9.npz through "
        f"ntt_small ({launches_r['ntt_small']} launches, dft_ntt {launches_r['dft_ntt']}); "
        f"keygen + create_proof {t_r:.3f}s (with MxuNTT, phase 3: "
        f"{t_keygen9 + t_prove9:.3f}s)")
    log(json.dumps({"mxu_runs": mxu_runs}))
    log(f"[mxu] phase 11 {time.time() - t11:.2f}s")

    # --- 12. msm: the MSM circuit at k=13 and k=17, the switches at k=12 --------------------
    launches_msm13, launches_msm17, launches_sw, largest_msm = msm_phase()

    # --- 13. api: the MSM at 2^20, the NTT at 2^20 and 2^22, the API at k=15 ------------------
    launches_api, largest_api = api_phase()

    # --- 5. every kernel at its main-path shapes: check and time ----------------------------
    # the plain versions at the k=17 shapes take tens of GiB of temporaries
    log(f"[timing] device memory before phase 5: {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    def numel(shape) -> int:
        out = 1
        for d in shape:
            out *= d
        return out

    def bound(name, spec):
        """(bound_ms, bound_by): bytes each input read once and each output
        written once, against operations at the 32-bit peak."""
        if name in ("mont_mul", "field_add", "field_sub"):
            sa, sb = spec
            n = max(numel(sa), numel(sb)) // 16
            nbytes = 4 * (numel(sa) + numel(sb)) + 64 * n
            ops = n * (MM_OPS if name == "mont_mul" else 2 * 16)
        elif name == "fermat_inv":
            # the batches of divsteps this run's elements need (one for 0)
            n = numel(spec[0]) // 16
            nbytes, ops = 128 * n, work["inv_batches"] * INV_BATCH_OPS
        elif name == "commit_dbl_add":
            # the scalars and the m bases read once, [16, C] Jacobian sums
            # written; the doublings, mixed adds and tree adds these scalars
            # need (commit_work)
            (C, _, m), _ = spec
            nbytes, ops = 64 * (C * m + 2 * m + 3 * C), work["commit"][0] * MM_OPS
        elif name == "g1_batch_mul":
            # the scalars and the comb table read once, [16, n] Jacobian sums
            # written; the mixed adds these scalars' signed digits need
            # (comb_work; work["g1_old"] keeps the double-and-add's count)
            (_, n), = spec
            nbytes = 64 * (n + 3 * n) + 64 * cf.COMB_WINDOWS * cf.COMB_HALF
            ops = work["g1"][0] * MM_OPS
        elif name == "ntt_butterfly":
            sa, sw = spec
            n = numel(sa) // 16
            nbytes = 4 * (2 * numel(sa) + numel(sw)) + 128 * n
            ops = n * (MM_OPS + 3 * 16)
        elif name == "ntt_small":
            # x read and written once, the twiddle row and the diagonals read
            # once; (n/2) log2 n butterflies a column and the diagonal products
            (C, _, n), with_pre, post_n = spec
            nbytes = 128 * C * n + 32 * n + (64 * n if with_pre else 0) + 64 * post_n
            ops = (C * n // 2 * (n.bit_length() - 1) * (MM_OPS + 3 * 16)
                   + C * n * MM_OPS * (int(with_pre) + int(post_n > 0)))
        elif name == "dft_stage":
            # x, the planes and the diagonals read once, the output written
            # once; the digit-pair multiply-adds at the int8 rate, and the
            # epilogue's 32-bit operations: the carries of 63 columns, two
            # ladders, two products and two adds an output, the diagonals'
            # products
            (L, _, R, C), Ro, with_pre, post_n = spec
            nbytes = (64 * L * C * (R + Ro) + 32 * Ro * R + (64 * R * C if with_pre else 0)
                      + 64 * post_n)
            t_macs = 1024 * R * Ro * L * C / PEAK_MACS8 * 1e3
            ops = (L * Ro * C * (63 * 4 + 2 * 3 * 16 + 2 * MM_OPS + 2 * 2 * 8
                                 + (MM_OPS if post_n else 0))
                   + (L * R * C * MM_OPS if with_pre else 0))
            t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, max(ops / PEAK_OPS32 * 1e3, t_macs)
            work["dft_parts"] = {"bytes_ms": t_bytes, "int8_macs_ms": t_macs,
                                 "ops32_ms": ops / PEAK_OPS32 * 1e3}
            return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        elif name == "dft_ntt":
            # x, the planes, the twiddle and the diagonals read once, the
            # output written once; both stages' digit-pair multiply-adds at
            # the int8 rate, and the 32-bit operations: two epilogues an
            # output (carries, ladders, two products and two adds each), the
            # twiddle product, the diagonals' products
            (L, _, n), with_pre, post_n = spec
            N1 = 1 << -(-(n.bit_length() - 1) // 2)
            N2 = n // N1
            nbytes = (128 * L * n + 32 * (N1 * N1 + N2 * N2) + 64 * n
                      + (64 * n if with_pre else 0) + 64 * post_n)
            t_macs = 1024 * L * n * (N1 + N2) / PEAK_MACS8 * 1e3
            ops = L * n * (2 * (63 * 4 + 2 * 3 * 16 + 2 * MM_OPS + 2 * 2 * 8) + MM_OPS
                           + MM_OPS * (int(with_pre) + int(post_n > 0)))
            t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, max(ops / PEAK_OPS32 * 1e3, t_macs)
            work["dft_ntt_parts"] = {"bytes_ms": t_bytes, "int8_macs_ms": t_macs,
                                     "ops32_ms": ops / PEAK_OPS32 * 1e3}
            return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        elif name == "colntt":
            (L, A, _, B), with_mid = spec
            n = L * A * B
            nbytes = 64 * n * (3 if with_mid else 2) + 32 * A
            # (A/2) log2(A) butterflies per column, then the mid product
            ops = n * (A.bit_length() - 1) // 2 * (MM_OPS + 3 * 16) + (n * MM_OPS if with_mid else 0)
        elif name == "ec_add":
            # the add path's 16 products on every lane (the doubling branch,
            # 8 + 7, and the identity lanes, 0, do no more)
            n = numel(spec[0]) // 16
            nbytes, ops = 9 * 64 * n, n * 16 * MM_OPS
        elif name == "ec_double":
            n = numel(spec[0]) // 16
            nbytes, ops = 6 * 64 * n, n * 7 * MM_OPS
        elif name == "ec_madd":
            shape, ashape, distinct = spec
            n, na = numel(shape) // 16, numel(ashape) // 16
            # P1 in and the result out (3 coordinates each), the affine bases
            # once (shared by every row when they broadcast)
            nbytes, ops = 64 * (6 * n + 2 * na), n * (11 if distinct else 17) * MM_OPS
        elif name == "bucket_weight":
            (Wtot, _, nb), lanes = spec
            # per window, the function's own work: T_w = sum_b b * S_b as two
            # running sums from the top bucket down (2 nb - 2 complete adds)
            # and the log2(lanes) doublings; the suffix scans' extra adds are
            # overhead of this design (see design_adds), not part of the bound
            nbytes = 3 * 64 * Wtot * (nb + 1)
            ops = Wtot * (16 * (2 * nb - 2) + 7 * (lanes.bit_length() - 1)) * MM_OPS
        elif name == "msm_combine":
            (_, CW), W, c = spec
            C = CW // W
            # W * c doublings and W - 1 adds (the first meets the identity)
            nbytes = 3 * 64 * (CW + C)
            ops = C * (7 * W * c + 16 * (W - 1)) * MM_OPS
        elif name == "bucket_sums_fused":
            (Wtot, n), (npts, _), _, nb, distinct = spec
            # the packed bases once, the sorted order and digits once, the
            # bucket sums written once; a mixed add for every live slot of
            # this run's digits (dead slots add nothing; the carry scan's adds
            # are this design's, not the function's)
            nbytes = 64 * npts + 8 * Wtot * n + 3 * 64 * Wtot * nb
            ops = work["live_slots"] * (11 if distinct else 17) * MM_OPS
        else:
            (Wb, R, _, CL), distinct = spec
            n = Wb * R * CL
            nbytes = n * (64 + 4 + 192)
            ops = n * (11 if distinct else 17) * MM_OPS
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_OPS32 * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def design_adds(spec) -> int:
        """Complete adds bucket_weight runs per window: the acc chain's past
        each lane's first bucket, the tot chain's past its first row, the
        three Hillis-Steele suffix scans' adds of lanes in range, D and + TS."""
        (_, _, nb), lanes = spec
        R2, levels = -(-nb // lanes), lanes.bit_length() - 1
        scans = 3 * sum(lanes - (1 << d) for d in range(levels))
        return (nb - lanes) + lanes * (R2 - 1) + scans + 2

    def serial_products(name, spec) -> int:
        """Montgomery products on the fused kernel's longest dependent chain
        (complete adds at their 16, doublings at 7)."""
        if name == "bucket_weight":
            (_, _, nb), lanes = spec
            levels = lanes.bit_length() - 1
            return 16 * (2 * -(-nb // lanes) + 3 * levels + 2) + 7 * levels
        if name == "bucket_sums_fused":
            # a lane's R mixed adds, then its carry scan's levels and the fix
            (_, n), _, lanes, _, distinct = spec
            return (n // lanes) * (11 if distinct else 17) + 16 * ((lanes - 1).bit_length() + 1)
        if name == "commit_dbl_add":
            return work["commit"][1]
        if name == "g1_batch_mul":
            return work["g1"][1]
        if name == "ntt_small":
            return ntt_chain(spec)[1]
        (_, CW), W, c = spec
        return 7 * W * c + 16 * W

    rows = []
    work = {}  # data-dependent work of this run's inputs, for the bounds

    def path_inputs(name, spec):
        """Inputs at a main-path shape where make_inputs' random ones would
        not do: colntt's stage twiddles start at the Montgomery one, as the
        NTT's do; bucket_sums_fused takes the digits random scalars give (no
        special windows), and this run's live slots are counted."""
        if name == "bucket_sums_fused":
            args = bucket_case(gen, torch, cf, spec, P[cf.FQ], special=False)[0]
            work["live_slots"] = int((args[2] > 0).sum())
            return cf.FQ, args
        fid, args = make_inputs(name, spec)
        if name == "colntt":
            args[1][:, 0] = mont_one
        return fid, args
    for name in cf.KERNELS:
        # the kernels off the main path are timed at the shapes it gave them
        # before their fusion
        spec = (COMPARE_SHAPES.get(name) or (largest_e.get(name) or largest15.get(name)
                or largest9.get(name) or largest_p.get(name) or largest_mesh.get(name)
                or OFF_PATH_SHAPES[name])[1])
        if name in ("colntt", "bucket_sums_fused"):
            fid, args = path_inputs(name, spec)
            err = max_err(run(name, fid, args, False), run(name, fid, args, True))
            if err:
                raise AssertionError(f"{name} at {spec} disagrees with its plain version")
        elif name == "g1_batch_mul":
            # the plain version at 2^20 lanes runs once, timed as it is checked
            fid, args = make_inputs(name, spec)
            got = run(name, fid, args, False)
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            want = run(name, fid, args, True)
            e1.record()
            torch.cuda.synchronize()
            plain_once = e0.elapsed_time(e1)
            err = max_err(got, want)
            if err:
                raise AssertionError(f"g1_batch_mul at {spec} disagrees with its plain version")
            # the old double-and-add kernel on the same scalars: the same
            # affine points
            old = cf.g1_chain_bench(*args)
            if max_err(_affine_mont(dcq.df, *got), _affine_mont(dcq.df, *old)):
                raise AssertionError("g1_batch_mul at 2^20 lanes: affine points differ from the "
                                     "old double-and-add kernel's")
            del got, want, old
            work["g1"] = comb_work(cf, torch, args[0])
            old_lanes = chain_work(taus19 + lag19)
            work["g1_old"] = (sum(old_lanes), max(old_lanes))
        else:
            fid, args, err = check(name, spec)
        if name == "fermat_inv":
            steps = [divsteps_needed(x, P[fid]) for x in host_ints(args[0])]
            work["inv_batches"] = sum(max(1, -(-d // 30)) for d in steps)
        if name == "commit_dbl_add":
            work["commit"] = commit_work(host_ints(args[0]), spec[0][2])
        reps = 3 if name in ("bucket_scan", "bucket_sums_fused") else 10
        ms = time_ms(lambda: run(name, fid, args, plain=False), reps)
        plain_ms = (plain_once if name == "g1_batch_mul"
                    else time_ms(lambda: run(name, fid, args, plain=True), 1))
        bms, by = bound(name, spec)
        src, rep = SOURCES[name]
        library_ms = None
        if name == "dft_stage":
            # the product part's yardstick: one int8 GEMM of the stage's
            # shape (M = 32 Ro, K = R, N = 32 C L: every digit pair, before
            # the fold), which the port never calls
            (L, _, R, C), Ro = spec[0], spec[1]
            ga = torch.randint(-128, 128, (32 * Ro, R), generator=gen, device=dev,
                               dtype=torch.int32).to(torch.int8)
            gb = torch.randint(-128, 128, (R, 32 * C * L), generator=gen, device=dev,
                               dtype=torch.int32).to(torch.int8)
            library_ms = time_ms(lambda: torch._int_mm(ga, gb), reps)
        row = {
            "name": name,
            "route": "cuda",
            "source": f"halo2_lib_tpu_torch/{src}",
            "replaces": rep,
            # the main path's launches: the k=9, the two phase-3b k=9
            # circuits', the k=15 slice, the ECDSA, the pairing, the
            # pipelined ECDSA (phase 7), the device mock, the gadget runs,
            # the mesh proofs (phase 10), the MSM circuit at k=13 and k=17,
            # the k=12 switch proofs (phase 12) and the API phase (13)
            "launches": (launches9[name] + launches_3b[name] + launches15[name] + launches_e[name]
                         + launches_p[name] + launches_b[name] + launches_m[name]
                         + launches_g[name] + launches_mesh[name] + launches_msm13[name]
                         + launches_msm17[name] + launches_sw[name] + launches_api[name]),
            "launches_k9": launches9[name],
            "launches_k9_phases": launches_3b[name],
            "launches_k15": launches15[name],
            "launches_ecdsa": launches_e[name],
            "launches_pairing": launches_p[name],
            "launches_bench_pipelined": launches_b[name],
            "launches_mock": launches_m[name],
            "launches_gadgets": launches_g[name],
            "launches_mesh": launches_mesh[name],
            "launches_msm_k13": launches_msm13[name],
            "launches_msm_k17": launches_msm17[name],
            "launches_switches": launches_sw[name],
            "launches_api": launches_api[name],
            "max_abs_err": err,
            "ms": round(ms, 6),
            "plain_ms": round(plain_ms, 6),
            "bound_ms": round(bms, 6),
            "bound_by": by,
            "library_ms": None if library_ms is None else round(library_ms, 6),
            "shape": [list(s) if isinstance(s, tuple) else s for s in spec],
            "shape_spec": spec,
        }
        if name in FUSES:
            row["fuses"] = FUSES[name]
        if name in ("dft_stage", "ntt_small", "dft_ntt"):
            # the same launch as a CUDA graph: the device's time alone
            row["graph_ms"] = round(graph_ms(lambda: run(name, fid, args, plain=False), reps), 6)
            log(f"[timing] {name} at {spec} as a CUDA graph: {row['graph_ms']:.4f} ms")
        if name == "dft_stage":
            row["bound_parts_ms"] = {k: round(v, 6) for k, v in work["dft_parts"].items()}
            log(f"[timing] dft_stage at {spec}: {ms:.4f} ms; the int8 GEMM of its pair products "
                f"(torch._int_mm, no fold) {library_ms:.4f} ms; bound parts (ms) "
                + json.dumps(row["bound_parts_ms"]))
        if name == "g1_batch_mul":
            # the old double-and-add kernel and the comb on the same
            # scalars, in turns old, comb, comb, old
            pol = {"old double-and-add": lambda: cf.g1_chain_bench(*args),
                   "comb": lambda: cf.g1_batch_mul(*args)}
            turns = {k: [] for k in pol}
            for k in list(pol) + list(pol)[::-1]:
                turns[k].append(round(time_ms(pol[k], 3), 4))
            row["turns_ms"] = turns
            row["bound_old_algorithm_ms"] = round(work["g1_old"][0] * MM_OPS / PEAK_OPS32 * 1e3, 6)
            row["ptxas"] = {k: ptxas.get(k) for k in ("g1_fixed_mul_k", "commit_chain_k")}
            log(f"[timing] g1_batch_mul at {spec} (ms, CUDA events, turns): " + json.dumps(turns)
                + f"; bound {bms:.4f} ms for the comb's {work['g1'][0]} products, "
                f"{row['bound_old_algorithm_ms']:.4f} ms for the double-and-add's "
                f"{work['g1_old'][0]}; ptxas (registers, spill stores, spill loads): "
                + json.dumps(row["ptxas"]))
        if name == "dft_ntt":
            # the three launches it replaced (dft_stage, the transpose,
            # dft_stage), in turns old, new, new, old; as CUDA events and as
            # CUDA graphs
            var = {"old: dft_stage, transpose, dft_stage":
                       lambda: cf.dft_two_stages(cf.dft_stage, fid, *args),
                   "dft_ntt": lambda: cf.dft_ntt(fid, *args)}
            outs = [fn() for fn in var.values()]
            if any(not torch.equal(o, outs[0]) for o in outs):
                raise AssertionError(f"dft_ntt at {spec} differs from the old composition")
            turns, gturns = {k: [] for k in var}, {k: [] for k in var}
            for k in list(var) + list(var)[::-1]:
                turns[k].append(round(time_ms(var[k], reps), 6))
                gturns[k].append(round(graph_ms(var[k], reps), 6))
            row["turns_ms"], row["graph_turns_ms"] = turns, gturns
            row["bound_parts_ms"] = {k: round(v, 6) for k, v in work["dft_ntt_parts"].items()}
            row["ptxas"] = {k: ptxas.get(k) for k in ("dft_ntt_k", "dft_stage")}
            log(f"[timing] dft_ntt at {spec} (ms, turns): events " + json.dumps(turns)
                + "; CUDA graphs " + json.dumps(gturns) + "; bound parts (ms) "
                + json.dumps(row["bound_parts_ms"]) + "; ptxas (registers, spill stores, spill "
                "loads): " + json.dumps(row["ptxas"]))
        rows.append(row)
        log(f"[timing] {name} at {spec}: {ms:.4f} ms (plain {plain_ms:.3f} ms, "
            f"bound {bms:.4f} ms by {by}), kernel == plain")
        if name in FUSES and name not in ("dft_stage", "dft_ntt"):
            log(f"[timing] {name}: its longest thread runs a chain of "
                f"{serial_products(name, spec)} dependent Montgomery products, a floor the "
                f"roofline bound does not see")
        if name == "bucket_weight":
            nb = spec[0][2]
            log(f"[timing] bucket_weight: {design_adds(spec)} complete adds per window where "
                f"the weighted sum needs {2 * nb - 2} (the suffix scans' extra adds)")
        if name == "fermat_inv":
            log(f"[timing] fermat_inv: its longest thread runs {-(-max(steps) // 30)} batches of "
                f"30 divsteps ({max(steps)} divsteps before g = 0), each batch's 2x2 matrix "
                f"applied to 9-limb (f, g) and (d, e); the Fermat chain ran about 330 dependent "
                f"Montgomery products")
        if name == "ntt_small":
            # the per-stage composition it replaced, at the same shape
            x, tw, pre, post = args
            if not torch.equal(ntt_stages(fid, x, tw, pre, post),
                               cf.ntt_small(fid, *args)):
                raise AssertionError(f"ntt_small at {spec} differs from the per-stage composition")
            old_ms = time_ms(lambda: ntt_stages(fid, x, tw, pre, post), reps)
            row["composition_ms"] = round(old_ms, 6)
            runs = ntt_chain(spec)[0]
            log(f"[timing] ntt_small at {spec}: {ms:.4f} ms against {old_ms:.4f} ms for the "
                f"per-stage composition it replaced ({x.shape[-1].bit_length() - 1} ntt_butterfly "
                f"launches and interleaves, {int(pre is not None) + int(post is not None)} "
                f"mont_mul), equal "
                f"outputs; a thread runs {runs} Montgomery products")
        if name == "commit_dbl_add":
            # the same columns at m = 1024, the longest the path sends it
            C = spec[0][0]
            spec_big = ((C, 16, 1024), (16, 1024))
            args_big = commit_case(gen, torch, cf, spec_big, P)
            if max_err(cf.commit_dbl_add(*args_big), cf.commit_dbl_add_plain(*args_big)):
                raise AssertionError(f"commit_dbl_add at {spec_big} disagrees with its plain "
                                     f"version")
            ms_big = time_ms(lambda: cf.commit_dbl_add(*args_big), reps)
            work["commit"] = commit_work(host_ints(args_big[0]), 1024)
            bms_big, by_big = bound(name, spec_big)
            log(f"[timing] commit_dbl_add at {spec_big}: {ms_big:.4f} ms (bound {bms_big:.4f} ms "
                f"by {by_big}; a chain of {work['commit'][1]} dependent Montgomery products), "
                f"kernel == plain")

    # every kernel whose largest launch in the k=17 MSM run (phase 12) does
    # more work than the shape timed above, and every kernel at its largest
    # launch of the API phase (13: the MSM over 2^20 distinct bases, the NTT
    # at 2^20 and 2^22) where that shape is not the one timed above: checked,
    # timed (kernel 3 or 10 launches, plain version once) and bounded there
    todo = []
    for row in rows:
        name = row["name"]
        if name in COMPARE_SHAPES:
            continue
        base = (largest_e.get(name) or largest15.get(name) or largest9.get(name)
                or largest_p.get(name) or largest_mesh.get(name) or OFF_PATH_SHAPES[name])
        if name in largest_msm and largest_msm[name][0] > base[0]:
            todo.append((row, "at_msm_k17", "the k=17 MSM run's", largest_msm[name][1]))
        if (name in API_KERNELS and name in largest_api
                and largest_api[name][1] != row["shape_spec"]):
            todo.append((row, "at_api", "the API phase's", largest_api[name][1]))
        if name == "colntt":
            # the first level of the 2^22 plan [2, 128, 128, 128], a shape no
            # other path launches
            todo.append((row, "at_api_a2", "the 2^22 plan's first level's",
                         ((1, 2, 16, 1 << 21), True)))
    for row, key, whose, spec in todo:
        name = row["name"]
        if name in ("mont_mul", "field_add", "field_sub") and numel(spec[0]) > 1 << 29:
            # the quotient's whole stacks: the plain version's int64
            # temporaries at that size would pass the card's memory
            log(f"[timing] {name}: {whose} largest launch {spec} (more than 2 GiB "
                f"an operand) not timed; a bytes-bound kernel, its time scales from the row's")
            continue
        fid, args = path_inputs(name, spec)
        got = run(name, fid, args, False)
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        want = run(name, fid, args, True)
        e1.record()
        torch.cuda.synchronize()
        err = max_err(got, want)
        if err:
            raise AssertionError(f"{name} at {whose} shape {spec} disagrees with its plain "
                                 f"version")
        del got, want
        if name == "fermat_inv":
            steps = [divsteps_needed(x, P[fid]) for x in host_ints(args[0])]
            work["inv_batches"] = sum(max(1, -(-d // 30)) for d in steps)
        reps = 3 if name in ("bucket_scan", "bucket_sums_fused") else 10
        ms = time_ms(lambda: run(name, fid, args, plain=False), reps)
        bms, by = bound(name, spec)
        row[key] = {
            "shape": [list(x) if isinstance(x, tuple) else x for x in spec],
            "ms": round(ms, 6), "plain_ms": round(e0.elapsed_time(e1), 6),
            "bound_ms": round(bms, 6), "bound_by": by, "max_abs_err": err,
        }
        log(f"[timing] {name} at {whose} largest shape {spec}: {ms:.4f} ms (plain "
            f"{row[key]['plain_ms']:.3f} ms, bound {bms:.4f} ms by {by}), kernel == plain")
        del args
    for row in rows:
        del row["shape_spec"]

    # --- 5b. one whole MSM at the ECDSA advice commit's shape: old vs fused buckets ---------
    def old_tail(dc, S, W: int, c: int, CL2: int):
        """The MSM's tail before the fusion: the merged-lane weighted bucket
        reduction and the window combine as loops of single ec_add /
        ec_double launches (ops/ec_device.py before bucket_weight and
        msm_combine)."""
        Wtot, _, nb = S[0].shape
        R2 = -(-nb // CL2)
        M = Wtot * CL2
        St = tuple(
            torch.nn.functional.pad(t, (0, R2 * CL2 - nb)).reshape(Wtot, 16, R2, CL2) for t in S
        )
        rows = tuple(t.permute(2, 1, 0, 3).reshape(R2, 16, M).flip(0) for t in St)
        acc = tot = dc.identity((M,), dev)
        for r in range(R2):
            acc = cf.ec_add(acc, tuple(t[r] for t in rows))
            tot = cf.ec_add(tot, acc)

        def suffix_local(Pt):
            l_loc = torch.arange(Pt[0].shape[-1], device=dev) % CL2
            for d in range(max(CL2.bit_length() - 1, 1)):
                ok = (l_loc + (1 << d) < CL2)[None, :]
                Qt = tuple(torch.where(ok, torch.roll(t, -(1 << d), dims=-1), torch.zeros_like(t))
                           for t in Pt)
                Pt = cf.ec_add(Pt, Qt)
            return Pt

        suf1 = suffix_local(tuple(torch.cat([a, t], dim=-1) for a, t in zip(acc, tot)))
        sufA = tuple(t[..., :M] for t in suf1)
        suf2 = suffix_local(sufA)
        TA = tuple(t[..., 0::CL2] for t in sufA)
        TT = tuple(t[..., M::CL2] for t in suf1)
        TS = tuple(t[..., 0::CL2] for t in suf2)
        D = cf.ec_add(TT, (TA[0], dc.df._neg(TA[1]), TA[2]))
        for _ in range(CL2.bit_length() - 1):
            D = cf.ec_double(D)
        tX, tY, tZ = cf.ec_add(D, TS)
        res = dc.identity((Wtot // W,), dev)
        for w in range(W - 1, -1, -1):
            for _ in range(c):
                res = cf.ec_double(res)
            res = cf.ec_add(res, tuple(t.reshape(16, Wtot // W, W)[..., w] for t in (tX, tY, tZ)))
        return res

    def wall_ms(fn, reps: int):
        """Mean host-clock milliseconds of fn() between synchronizes (the old
        bucket accumulation synchronizes inside, at its carry gathers);
        returns the last result too."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps, out

    C5, c5 = 21, 10
    dc5 = params.device_curve()
    bases5 = params.affine_lagrange_bases(dev)
    vals5 = fr_df._to_mont(rand_limbs(gen, (C5, 16, params.n), torch, P[cf.FR]))
    digits5 = window_digits(fr_df, vals5, c5)  # [C, W, n]
    W5 = digits5.shape[1]
    CL5 = _scan_lanes(params.n, dev)
    CL2_5 = weight_lanes((1 << c5) - 1, params.n, dev)

    def old_msm(st=None):
        """The parent's MSM: the bucket_scan composition, then the fused tail."""
        S = old_bucket_sums(cf, torch, bases5, digits5, c5, True, CL5, st)
        out = cf.msm_combine(cf.bucket_weight(S, CL2_5), W5, c5)
        if st is not None:
            st.mark("tail")
        return out, S

    def new_msm(st=None):
        """msm_many_device; with `st`, its steps one by one (ops/ec_device.py
        bucket_sums at k = 15: one group of windows) between stage marks."""
        if st is None:
            return msm_many_device(dc5, bases5, digits5, c5, True), None
        flat = digits5.reshape(-1, params.n).to(torch.int32)
        d_sorted, order = torch.sort(flat, dim=1, stable=True)
        order = order.to(torch.int32)
        st.mark("sort")
        packed = cf.pack_bases(*bases5)
        st.mark("pack")
        S = cf.bucket_sums_fused(packed, order, d_sorted, CL5, (1 << c5) - 1, True)
        st.mark("fused")
        out = cf.msm_combine(cf.bucket_weight(S, CL2_5), W5, c5)
        st.mark("tail")
        return out, S

    turns = {"old": old_msm, "new": new_msm}
    for fn in turns.values():  # warm-up
        fn()
    outs, sums, msm5 = {}, {}, []
    for name in ("old", "new", "new", "old"):
        ms_all, (outs[name], _) = wall_ms(turns[name], 3)
        st = Stages(torch)
        _, sums[name] = turns[name](st)
        stages = st.ms()
        msm5.append({"turn": name, "msm_ms": round(ms_all, 3),
                     "stages_ms": {k: round(v, 3) for k, v in stages.items()}})
        log(f"[msm] {name}: one MSM of {C5} columns x {params.n} points (window {c5}, "
            f"{W5} windows, {CL5} scan lanes, {CL2_5} weight lanes): {ms_all:.3f} ms; stages "
            f"(ms, CUDA events) " + stage_line(stages))
    if any(not torch.equal(a, b) for a, b in zip(sums["old"], sums["new"])):
        raise AssertionError("MSM: bucket_sums_fused's sums differ from the bucket_scan composition's")
    if any(not torch.equal(a, b) for a, b in zip(outs["old"], outs["new"])):
        raise AssertionError("MSM: the fused bucket sums' Jacobian output differs from the old one")
    log("[msm] bucket sums and MSM points equal bit for bit, old and new")

    # the step-loop tail against the fused one
    S5 = sums["new"]
    tails = {
        "old": lambda: old_tail(dc5, S5, W5, c5, CL2_5),
        "new": lambda: cf.msm_combine(cf.bucket_weight(S5, CL2_5), W5, c5),
    }
    tail_ms = {k: time_ms(fn, 3) for k, fn in tails.items()}
    if any(not torch.equal(a, b) for a, b in zip(tails["old"](), tails["new"]())):
        raise AssertionError("MSM: the fused tail's Jacobian output differs from the step loop's")
    big = tuple(rand_limbs(gen, (16, 139776), torch, P[cf.FQ]) for _ in range(6))
    ms_add_big = time_ms(lambda: cf.ec_add(big[:3], big[3:]), 10)
    log(f"[msm] tail: step loop {tail_ms['old']:.3f} ms, fused {tail_ms['new']:.3f} ms, same "
        f"Jacobian points; ec_add at [16, 139776] (the step loop's widest launch): "
        f"{ms_add_big:.4f} ms")

    # the Montgomery product alone: dependent chains, carry-chain vs 64-bit C
    lanes_mul, iters_mul = 132 * 2048, 256
    ma, mb = (rand_limbs(gen, (16, lanes_mul), torch, P[cf.FQ]) for _ in range(2))
    if not torch.equal(cf.mul_chain_bench(ma, mb, iters_mul, True),
                       cf.mul_chain_bench(ma, mb, iters_mul, False)):
        raise AssertionError("the carry-chain product differs from the 64-bit C one")
    mul_turns = []
    for chains in (False, True, True, False):
        ms = time_ms(lambda: cf.mul_chain_bench(ma, mb, iters_mul, chains), 5)
        rate = lanes_mul * iters_mul / ms / 1e6
        mul_turns.append({"product": "carry chains" if chains else "64-bit C", "ms": round(ms, 4),
                          "g_products_per_s": round(rate, 3)})
        log(f"[mul] {'carry-chain' if chains else '64-bit C'} product: {lanes_mul} threads x "
            f"{iters_mul} dependent products in {ms:.4f} ms, {rate:.2f} G products/s")
    log(json.dumps({"msm_turns": msm5, "tail_ms": {k: round(v, 3) for k, v in tail_ms.items()},
                    "ec_add_16x139776_ms": round(ms_add_big, 6), "mul_chain": mul_turns}))

    log(f"[total] chip_smoke.py {time.time() - t_start:.1f}s")
    log(nvidia_smi())
    log(json.dumps({"kernels": rows}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
